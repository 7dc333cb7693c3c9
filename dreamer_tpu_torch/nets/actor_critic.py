"""The actor and the critic (``dreamer_tpu/nets/actor_critic.py``).

Both read [h ‖ flat(z)] through two Dense+LN+SiLU layers.  The actor ends in
a mu head, zero initialised (weights and bias) so that the first policy is
centred at tanh(0) = 0, and a log-sigma head; the critic in one Dense to the
twohot value logits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from dreamer_tpu_torch.core.dists import actor_mu_sigma
from dreamer_tpu_torch.nets.layout import KernelLayout
from dreamer_tpu_torch.nets.mlp import MLP, Dense, ln_silu_trunk, make_trunk
from dreamer_tpu_torch.ops.imagine_cuda import layer_operands


class Actor(nn.Module):
    def __init__(self, in_dim: int, action_dim: int, hidden_1: int = 200,
                 hidden_2: int = 200, min_std: float = 1e-3,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.min_std = min_std
        self.dtype = dtype
        self.denses, self.norms = make_trunk(in_dim, (hidden_1, hidden_2), dtype,
                                             generator)
        self.mu_head = Dense(hidden_2, action_dim, dtype, zero_init=True)
        self.log_sig_head = Dense(hidden_2, action_dim, dtype, generator=generator)
        self._imagine_layout = KernelLayout(lambda *p: layer_operands(p, self.dtype))

    def imagine_weights(self):
        """The actor's operands of the imagine kernel
        (``ops.imagine_cuda.layer_operands``), remade only after the
        parameters change."""
        d, n = self.denses, self.norms
        return self._imagine_layout.get(
            d[0].weight, d[0].bias, n[0].scale, n[0].bias,
            d[1].weight, d[1].bias, n[1].scale, n[1].bias,
            self.mu_head.weight, self.mu_head.bias,
            self.log_sig_head.weight, self.log_sig_head.bias)

    def forward(self, h: torch.Tensor, z_flat: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu, sigma), each (..., action_dim), in float32."""
        x = torch.cat([h, z_flat], dim=-1).to(self.dtype)
        x = ln_silu_trunk(x, self.denses, self.norms)
        return actor_mu_sigma(self.mu_head(x).float(), self.log_sig_head(x).float(),
                              self.min_std)


class Critic(MLP):
    """Twohot value logits over ``num_buckets`` (``actor_critic.py:51-62``):
    the layers of an ``MLP`` (flax names ``Dense_0..2``, ``LayerNorm_0..1``),
    with float32 logits."""

    def __init__(self, in_dim: int, num_buckets: int = 255, hidden_1: int = 200,
                 hidden_2: int = 200, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_dim, (hidden_1, hidden_2), num_buckets, dtype, generator)
        self.dtype = dtype

    def forward(self, h: torch.Tensor, z_flat: torch.Tensor) -> torch.Tensor:
        x = torch.cat([h, z_flat], dim=-1).to(self.dtype)
        return super().forward(x).float()
