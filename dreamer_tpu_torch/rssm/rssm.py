"""The RSSM's single-step functions of the serving path
(``dreamer_tpu/rssm/rssm.py:55-173``).

State convention, as in JAX: ``h`` is the GRU state (B, hidden_dim) and ``z``
the flattened straight-through one-hot latent (B, rows*classes), both float32
at these functions' boundaries while the nets compute in the compute dtype.
Sampling takes gumbel noise of shape (..., rows, classes) instead of a key.
The sequence scans (observe, warm start, imagine) come with the training
slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from dreamer_tpu_torch.config import WorldModelConfig
from dreamer_tpu_torch.core.dists import sample_onehot_ste, unimix_probs
from dreamer_tpu_torch.nets.wm_nets import WMNets


class RSSM:
    """Functional wrapper around ``WMNets``: owns the module, exposes the
    serving path's steps."""

    def __init__(self, cfg: WorldModelConfig, action_dim: int = 3,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        self.cfg = cfg
        self.nets = WMNets(cfg, action_dim, dtype, generator)

    def encode_obs(self, obs_u8: torch.Tensor) -> torch.Tensor:
        return self.nets.encode_obs(obs_u8)

    def posterior_logits(self, feat: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return self.nets.posterior_logits(feat, h)

    def gru_step(self, z_flat: torch.Tensor, action: torch.Tensor,
                 h: torch.Tensor) -> torch.Tensor:
        # h enters the cell in the compute dtype and leaves it as float32
        # (rssm.py:117-121).
        return self.nets.gru_step(z_flat, action, h).float()

    def _sample(self, logits: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
        """Unimix + STE one-hot sample, flattened to (..., rows*classes)."""
        z = sample_onehot_ste(unimix_probs(logits, self.cfg.unimix), gumbel)
        return z.reshape(z.shape[:-2] + (self.cfg.latent_dim,))

    def encode_initial(self, obs_u8: torch.Tensor, gumbel: torch.Tensor,
                       h: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Posterior sample of a frame at (by default zero) hidden state: the
        episode-start encode."""
        if h is None:
            h = torch.zeros(obs_u8.shape[:-3] + (self.cfg.hidden_dim,),
                            device=obs_u8.device)
        feat = self.encode_obs(obs_u8)
        return self._sample(self.posterior_logits(feat, h), gumbel)

    def observe_step(self, z_flat, h, action, obs_u8, gumbel):
        """h' = GRU([z ‖ a], h); z' ~ q(. | h', obs').  Returns (z', h', logits)."""
        h_next = self.gru_step(z_flat, action, h)
        feat = self.encode_obs(obs_u8)
        logits = self.posterior_logits(feat, h_next)
        return self._sample(logits, gumbel), h_next, logits
