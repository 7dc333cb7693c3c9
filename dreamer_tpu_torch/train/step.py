"""The policy programs of ``Trainer`` (``dreamer_tpu/train/step.py:194-247``):
the per-env-step act/observe calls of rollout and eval, batched over N envs.

``Policy`` holds the world-model nets (through ``RSSM``) and the actor.  Its
noise is an argument: ``sample_noise`` draws it from the caller's
``torch.Generator`` on the serving path, and tests pass the noise JAX draws.
The learner methods of ``Trainer`` (``wm_step``, ``ac_step``,
``train_iteration``) join this class in the training slice.

On a CUDA device the encoder and the GRU cell run as the hand-written kernels
of ``dreamer_tpu_torch.ops``; those take bfloat16, so the card needs
``runtime.compute_dtype: bfloat16``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.core.dists import sample_gumbel
from dreamer_tpu_torch.nets.actor_critic import Actor
from dreamer_tpu_torch.rssm.rssm import RSSM

Tensor = torch.Tensor


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; the CPU only when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return dev


class PolicyNoise(NamedTuple):
    """The noise of one ``policy_act_observe`` call (JAX splits its key into
    ``k_obs, k_reset, k_act``, step.py:232)."""

    gumbel_obs: Tensor    # (N, rows, classes): the observe branch's latent
    gumbel_reset: Tensor  # (N, rows, classes): the reset branch's latent
    eps: Tensor           # (N, action_dim): the action's standard normal


class Policy:
    def __init__(self, cfg: DreamerConfig, device=None, seed: int = 0):
        """Build the nets at ``cfg``'s widths with weights drawn from ``seed``
        (on the CPU, so every device gets the same weights) and move them to
        ``device``."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.runtime.compute_dtype)
        gen = torch.Generator().manual_seed(seed)
        self.rssm = RSSM(cfg.wm, cfg.env.action_dim, self.dtype, gen)
        a = cfg.agent
        self.actor = Actor(cfg.wm.hidden_dim + cfg.wm.latent_dim, cfg.env.action_dim,
                           a.actor_hidden_1, a.actor_hidden_2, a.min_std, self.dtype, gen)
        self.rssm.nets.to(self.device)
        self.actor.to(self.device)
        self.rssm.nets.prepare_kernels()

    def sample_noise(self, n: int, generator: torch.Generator) -> PolicyNoise:
        """Draw one step's noise for ``n`` envs on the policy's device."""
        c = self.cfg.wm
        shape = (n, c.latent_rows, c.latent_classes)
        return PolicyNoise(
            sample_gumbel(shape, generator, self.device),
            sample_gumbel(shape, generator, self.device),
            torch.randn(n, self.cfg.env.action_dim, generator=generator, device=self.device))

    @torch.no_grad()
    def policy_reset(self, obs_u8: Tensor, gumbel: Tensor) -> Tuple[Tensor, Tensor]:
        """Episode-start state: h = 0, z = encode(h=0, obs).  obs_u8 (N, H, W, 3)."""
        h = torch.zeros(obs_u8.shape[0], self.cfg.wm.hidden_dim, device=obs_u8.device)
        return h, self.rssm.encode_initial(obs_u8, gumbel, h)

    @torch.no_grad()
    def policy_act(self, h: Tensor, z: Tensor, eps: Optional[Tensor] = None,
                   deterministic: bool = False) -> Tensor:
        """tanh(mu) if deterministic, else tanh(mu + sigma * eps)."""
        mu, sigma = self.actor(h, z)
        if deterministic:
            return torch.tanh(mu)
        return torch.tanh(mu + sigma * eps)

    @torch.no_grad()
    def policy_observe(self, z: Tensor, h: Tensor, action: Tensor, obs_u8: Tensor,
                       gumbel: Tensor) -> Tuple[Tensor, Tensor]:
        """Posterior step after an env transition.  Returns (z', h')."""
        z2, h2, _ = self.rssm.observe_step(z, h, action, obs_u8, gumbel)
        return z2, h2

    @torch.no_grad()
    def policy_act_observe(self, h: Tensor, z: Tensor, action_prev: Tensor,
                           obs_u8: Tensor, done: Tensor, noise: PolicyNoise,
                           deterministic: bool = False
                           ) -> Tuple[Tensor, Tensor, Tensor]:
        """One env step for N envs: the posterior update from the previous
        action and the new frame, with the rows flagged in ``done`` (N,)
        re-encoded from h = 0 instead, then the next action.

        One encoder pass serves both branches; only the posterior head runs
        twice.  Returns (h', z', action')."""
        rssm = self.rssm
        feat = rssm.encode_obs(obs_u8)
        h_step = rssm.gru_step(z, action_prev, h)
        z_step = rssm._sample(rssm.posterior_logits(feat, h_step), noise.gumbel_obs)
        h0 = torch.zeros_like(h)
        z_reset = rssm._sample(rssm.posterior_logits(feat, h0), noise.gumbel_reset)
        d = done[:, None].float()
        h_next = (1.0 - d) * h_step + d * h0
        z_next = (1.0 - d) * z_step + d * z_reset
        action = self.policy_act(h_next, z_next, noise.eps, deterministic)
        return h_next, z_next, action
