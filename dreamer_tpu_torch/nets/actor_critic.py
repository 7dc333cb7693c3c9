"""The actor (``dreamer_tpu/nets/actor_critic.py:20-40``).

It reads [h ‖ flat(z)] through two Dense+LN+SiLU layers into a mu head, zero
initialised (weights and bias) so that the first policy is centred at
tanh(0) = 0, and a log-sigma head.  The critic comes with the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from dreamer_tpu_torch.core.dists import actor_mu_sigma
from dreamer_tpu_torch.nets.mlp import Dense, ln_silu_trunk, make_trunk


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

    def forward(self, h: torch.Tensor, z_flat: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu, sigma), each (..., action_dim), in float32."""
        x = torch.cat([h, z_flat], dim=-1).to(self.dtype)
        x = ln_silu_trunk(x, self.denses, self.norms)
        return actor_mu_sigma(self.mu_head(x).float(), self.log_sig_head(x).float(),
                              self.min_std)
