"""The RSSM (``dreamer_tpu/rssm/rssm.py``): the single-step functions of the
serving path, the heads and the decoder, the posterior scan of the
world-model update, and the warm start and imagination of the actor-critic
update.

State convention, as in JAX: ``h`` is the GRU state (B, hidden_dim) and ``z``
the flattened straight-through one-hot latent (B, rows*classes), both float32
at these functions' boundaries while the nets compute in the compute dtype.
Sampling takes gumbel noise of shape (..., rows, classes) instead of a key.
The training paths (``observe_sequence``, ``warm_start``) normalise frames as
the JAX losses do, in the compute dtype (``conv_cuda.norm_table("train")``);
serving as the JAX policy programs do.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from dreamer_tpu_torch.config import WorldModelConfig
from dreamer_tpu_torch.core.dists import sample_onehot_ste, unimix_probs
from dreamer_tpu_torch.core.math import bucket_values, twohot_expectation
from dreamer_tpu_torch.nets.wm_nets import WMNets
from dreamer_tpu_torch.ops.imagine_scan import imagine_scan
from dreamer_tpu_torch.ops.observe_scan import observe_scan, observe_scan_reset


class ObservedSequence(NamedTuple):
    """The posterior unroll, batch-major (``rssm.py:31-36``)."""

    h: torch.Tensor            # (B, T, hidden) float32, post-step states
    z: torch.Tensor            # (B, T, rows*classes) straight-through samples
    post_logits: torch.Tensor  # (B, T, rows, classes) compute dtype


class ImaginedTrajectory(NamedTuple):
    """H+1 states, H actions, rewards and continues, batch-major; ``reward[t]``
    and ``cont[t]`` are the predictions at state t+1 (``rssm.py:40-55``)."""

    h: torch.Tensor       # (B, H+1, hidden)
    z: torch.Tensor       # (B, H+1, rows*classes)
    action: torch.Tensor  # (B, H, action_dim)
    reward: torch.Tensor  # (B, H) symexp'd reward prediction
    cont: torch.Tensor    # (B, H) continue probability
    mu: torch.Tensor      # (B, H, action_dim)
    sigma: torch.Tensor   # (B, H, action_dim)


class RSSM:
    """Functional wrapper around ``WMNets``: owns the module, exposes the
    serving path's steps."""

    def __init__(self, cfg: WorldModelConfig, action_dim: int = 3,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 nets: Optional[WMNets] = None):
        """Wraps ``nets`` when given (any device), else new nets drawn from
        ``generator``."""
        self.cfg = cfg
        self.nets = WMNets(cfg, action_dim, dtype, generator) if nets is None else nets

    def encode_obs(self, obs_u8: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.nets.encode_obs(obs_u8, train)

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

    # ------------------------------------------------------------------ #
    # Heads
    # ------------------------------------------------------------------ #

    def prior_logits(self, h: torch.Tensor) -> torch.Tensor:
        return self.nets.prior_logits(h)

    def reward_logits(self, h: torch.Tensor, z_flat: torch.Tensor) -> torch.Tensor:
        return self.nets.reward_logits(h, z_flat)

    def cont_logit(self, h: torch.Tensor, z_flat: torch.Tensor) -> torch.Tensor:
        return self.nets.cont_logit(h, z_flat)

    def decode(self, h: torch.Tensor, z_flat: torch.Tensor) -> torch.Tensor:
        return self.nets.decode(h, z_flat)

    def reward_pred(self, h: torch.Tensor, z_flat: torch.Tensor) -> torch.Tensor:
        """symexp(E[twohot]) of the reward head."""
        logits = self.nets.reward_logits(h, z_flat)
        buckets = bucket_values(self.cfg.reward_buckets, device=logits.device)
        return twohot_expectation(logits, buckets).squeeze(-1)

    def cont_pred(self, h: torch.Tensor, z_flat: torch.Tensor) -> torch.Tensor:
        """Continue probability, not thresholded."""
        return torch.sigmoid(self.nets.cont_logit(h, z_flat).float()).squeeze(-1)

    # ------------------------------------------------------------------ #
    # The world-model update's scan
    # ------------------------------------------------------------------ #

    def observe_sequence(self, obs_u8: torch.Tensor, actions: torch.Tensor,
                         gumbel: torch.Tensor, is_first: Optional[torch.Tensor] = None
                         ) -> ObservedSequence:
        """Open-loop posterior unroll over T steps from the zero state
        (``rssm.py:189-299``): step t consumes action[t-1] (zeros at t = 0)
        and obs[t], the GRU running at every step.  One encoder call covers
        all B*T frames; the scan is ``ops.observe_scan``, differentiable in
        the encoder, GRU and posterior-head parameters.

        obs_u8 (B, T, H, W, 3) uint8; actions (B, T, A); gumbel (T, B, rows,
        classes); ``is_first`` (B, T) zeroes h, z and the incoming action
        before the steps where it is 1 (``observe_scan_reset``)."""
        B = obs_u8.shape[0]
        feats = self.encode_obs(obs_u8, train=True).transpose(0, 1)
        a_in = torch.cat([torch.zeros_like(actions[:, :1]), actions[:, :-1]], dim=1)
        a_in = a_in.transpose(0, 1)
        h0 = torch.zeros(B, self.cfg.hidden_dim, device=obs_u8.device)
        z0 = torch.zeros(B, self.cfg.latent_dim, device=obs_u8.device)
        if is_first is None:
            out = observe_scan(self.nets, h0, z0, feats, a_in, gumbel)
        else:
            out = observe_scan_reset(self.nets, h0, z0, feats, a_in, gumbel,
                                     is_first.transpose(0, 1))
        return ObservedSequence(*(v.transpose(0, 1) for v in out))

    # ------------------------------------------------------------------ #
    # The actor-critic update's scans
    # ------------------------------------------------------------------ #

    def warm_start(self, obs_u8: torch.Tensor, actions: torch.Tensor, gumbel: torch.Tensor,
                   is_first: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced warm start (``rssm.py:301-354``): z0 is encoded from
        (h = 0, obs[0]) with no GRU step, then Tw - 1 observe steps consume
        action[t-1] and obs[t].  One encoder call covers all B*Tw frames.

        obs_u8 (B, Tw, H, W, 3) uint8; actions (B, Tw, A); gumbel (Tw, B,
        rows, classes); ``is_first`` (B, Tw) zeroes h, z and the incoming
        action where a window crosses an episode start.  Returns (z, h)."""
        B, Tw = obs_u8.shape[:2]
        feats = self.encode_obs(obs_u8, train=True)
        h = torch.zeros(B, self.cfg.hidden_dim, device=obs_u8.device)
        z = self._sample(self.posterior_logits(feats[:, 0], h), gumbel[0])
        for t in range(1, Tw):
            a_prev = actions[:, t - 1]
            if is_first is not None:
                keep = (1.0 - is_first[:, t].float())[:, None]
                h, z, a_prev = h * keep, z * keep, a_prev * keep.to(a_prev.dtype)
            h = self.gru_step(z, a_prev, h)
            z = self._sample(self.posterior_logits(feats[:, t], h), gumbel[t])
        return z, h

    def imagine(self, actor, z0: torch.Tensor, h0: torch.Tensor, eps: torch.Tensor,
                gum: torch.Tensor, min_std: float) -> ImaginedTrajectory:
        """The H-step dream of ``actor`` from (z0, h0) through
        ``ops.imagine_scan`` (the whole-rollout kernel on the card),
        differentiable in the actor's parameters only: the actor-critic
        update takes no world-model gradient, so the world model's enter
        detached.  eps (H, B, A), gum (H, B, rows, classes)."""
        out = imagine_scan(actor, self.nets, h0, z0, eps, gum, self.cfg.unimix, min_std,
                           wm_grad=False)
        return self._assemble_trajectory(*out)

    def _assemble_trajectory(self, h_fin, z_fin, h_seq, z_seq, a_seq, mu_seq, sig_seq
                             ) -> ImaginedTrajectory:
        """Time-major scan outputs -> the batch-major trajectory, with the
        reward and continue heads on states 1..H (``rssm.py:422-440``).  The
        heads feed only stop-gradient targets, so they run without a graph."""
        h_all = torch.cat([h_seq.transpose(0, 1), h_fin[:, None]], dim=1)
        z_all = torch.cat([z_seq.transpose(0, 1), z_fin[:, None]], dim=1)
        with torch.no_grad():
            reward = self.reward_pred(h_all[:, 1:], z_all[:, 1:])
            cont = self.cont_pred(h_all[:, 1:], z_all[:, 1:])
        return ImaginedTrajectory(h=h_all, z=z_all, action=a_seq.transpose(0, 1),
                                  reward=reward, cont=cont, mu=mu_seq.transpose(0, 1),
                                  sigma=sig_seq.transpose(0, 1))
