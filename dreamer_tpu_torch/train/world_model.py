"""The world-model loss and update (``dreamer_tpu/train/world_model.py:41-223``):
the posterior scan, the prior, reward, continue and decoder heads, the loss
terms with KL balancing and free bits, AdamW with a global-norm clip, and the
skip of a non-finite update.

Semantics, as in JAX (its module docstring gives the reference's quirks):

- only the first ``train.horizon`` steps of a batch are used, sliced before
  the frames are normalised; the reconstruction target is the frame
  normalised in the compute dtype, ``u.astype(dtype) / 255 - 0.5`` rounded
  twice (``conv_cuda.norm_table("train")``), the same values the encoder
  reads;
- the likelihoods run on steps 1..H-1, masked by the continue targets or,
  under ``env.next_step_autoreset``, by ``1 - firsts[:, 1:H]``; the KL terms
  are masked means with free bits after the mean, or per sample under
  ``wm.free_bits_per_sample``; ``wm.terminal_loss_weight`` reweighs the
  terminal targets; ``wm.reset_on_episode_start`` derives the scan's resets
  from the continue flags;
- a non-finite total skips the update: every parameter and optimizer-state
  tensor takes ``torch.where(finite, new, old)``, with no host sync; under
  ``runtime.debug_nans`` the update raises ``FloatingPointError`` first,
  naming the loss term, gradient or updated parameter (``train.debug``).

The noise is an argument: the posterior scan's gumbels (T, B, rows, classes).

Under a data-parallel ``plan`` (``parallel.MeshPlan``) the batch is this
rank's block of rows, and the update is that of the whole batch: the mask
count of the likelihoods' denominator and the KL means are summed over the
ranks, so free bits clamp the global mean (a rank's gradient of a KL term
flows where the global mean is at or above ``free_bits``); the gradients
are averaged and the update skipped on every rank where any rank's loss is
not finite (``MeshPlan.reduce_update``).  Under the model axis a rank
computes the step of its block of each sharded weight and keeps the moments
of that block (``AdamState.blocks``); ``MeshPlan.gather_weights`` writes
every rank's blocks, so each rank's weights stay whole.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.core.dists import categorical_kl
from dreamer_tpu_torch.core.math import bucket_values, twohot
from dreamer_tpu_torch.parallel.sharding import MeshPlan
from dreamer_tpu_torch.rssm.rssm import RSSM
from dreamer_tpu_torch.train.agent import AdamW, adamw_update, global_norm, write_update
from dreamer_tpu_torch.train.debug import check_finite
from dreamer_tpu_torch.train.state import WMTrainState

Tensor = torch.Tensor

# The loss terms ``runtime.debug_nans`` checks, the parts before the total.
LOSS_TERMS = ("wm/obs_sse", "wm/reward_ce", "wm/cont_ce", "wm/kl_dyn", "wm/kl_rep",
              "wm/loss_pred", "wm/loss")


def make_wm_optimizer(cfg: DreamerConfig) -> AdamW:
    """``chain(clip_by_global_norm(grad_clip), adamw(lr, betas, eps, weight_decay))``
    (``world_model.py:41-47``)."""
    w = cfg.wm
    return AdamW(w.lr, w.betas[0], w.betas[1], w.eps, w.weight_decay, w.grad_clip)


def wm_loss_terms(post_logits: Tensor, prior_logits: Tensor, dec_mu: Tensor,
                  rew_logits: Tensor, cont_logits: Tensor, obs: Tensor, rewards: Tensor,
                  conts: Tensor, buckets: Tensor, cfg: DreamerConfig,
                  valid_mask: Optional[Tensor] = None, plan: Optional[MeshPlan] = None
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The loss from the heads' outputs (``world_model.py:50-145``).  Shapes:
    post/prior logits (B, H, rows, classes); dec_mu, obs (B, H, h, w, 3);
    rew_logits (B, H-1, K); cont_logits (B, H-1); rewards, conts (B, H);
    ``valid_mask`` (B, H-1) replaces the continue targets as the mask.
    Under ``plan`` B is this rank's rows, and the loss is this rank's share
    of the global one: the ranks' mean is the global loss, and so is the
    mean of their gradients."""
    w = cfg.wm
    H = cfg.train.horizon

    # The pixel error in the decoder's dtype, its square summed in f32.
    err = dec_mu - obs.to(dec_mu.dtype)
    obs_sse = torch.sum(torch.square(err.float()), dim=(-3, -2, -1))   # (B, H)
    obs_log_lh = -obs_sse[:, 1:]

    rew_th = twohot(rewards[:, :H - 1], buckets)
    rew_logp = F.log_softmax(rew_logits.float(), dim=-1)
    rew_log_lh = torch.sum(rew_th * rew_logp, dim=-1)                  # (B, H-1)

    cont_targets = conts[:, :H - 1]
    x = cont_logits.float()
    cont_nll = -(cont_targets * F.logsigmoid(x) + (1.0 - cont_targets) * F.logsigmoid(-x))

    if w.terminal_loss_weight != 1.0:
        tw = 1.0 + (w.terminal_loss_weight - 1.0) * (1.0 - cont_targets)
        rew_log_lh = rew_log_lh * tw
        cont_nll = cont_nll * tw

    mask = cont_targets if valid_mask is None else valid_mask
    obs_log_lh = obs_log_lh * mask
    rew_log_lh = rew_log_lh * mask
    cont_nll = cont_nll * mask

    post, prior = post_logits[:, 1:], prior_logits[:, 1:]
    kl_dyn = categorical_kl(post.detach(), prior).sum(-1)              # (B, H-1)
    kl_rep = categorical_kl(post, prior.detach()).sum(-1)
    dkl_dyn = torch.mean(kl_dyn * mask)
    dkl_rep = torch.mean(kl_rep * mask)

    # The batch statistics: this rank's, or (under a plan) the whole
    # batch's, the mask count summed and the KL means averaged over ranks;
    # `share` makes a rank's normalised sums its share of the global ones.
    mask_sum, kl_dyn_mean, kl_rep_mean, share = torch.sum(mask), dkl_dyn, dkl_rep, 1.0
    if plan is not None:
        stats = plan.sum(torch.stack([mask_sum, dkl_dyn, dkl_rep]))
        mask_sum, share = stats[0], float(plan.world_size)
        kl_dyn_mean, kl_rep_mean = stats[1] / share, stats[2] / share
    denom = mask_sum + 1e-5
    loss_pred = share * (-torch.sum(obs_log_lh) - torch.sum(rew_log_lh)
                         + torch.sum(cont_nll)) / denom

    if w.free_bits_per_sample:
        loss_dyn = torch.mean(torch.clamp(kl_dyn, min=w.free_bits) * mask)
        loss_rep = torch.mean(torch.clamp(kl_rep, min=w.free_bits) * mask)
    elif plan is None:
        loss_dyn = torch.clamp(dkl_dyn, min=w.free_bits)
        loss_rep = torch.clamp(dkl_rep, min=w.free_bits)
    else:
        # Free bits after the global mean: clamp(mean, fb) has the mean's
        # gradient where mean >= fb and none below.
        fb = w.free_bits
        loss_dyn = torch.where(kl_dyn_mean >= fb, dkl_dyn, torch.full_like(dkl_dyn, fb))
        loss_rep = torch.where(kl_rep_mean >= fb, dkl_rep, torch.full_like(dkl_rep, fb))

    total = w.beta_pred * loss_pred + w.beta_dyn * loss_dyn + w.beta_rep * loss_rep
    metrics = {
        "wm/loss": total.detach(),
        "wm/loss_pred": loss_pred.detach(),
        "wm/kl_dyn": dkl_dyn.detach(),
        "wm/kl_rep": dkl_rep.detach(),
        "wm/obs_sse": (share * torch.sum(obs_sse[:, 1:] * mask) / denom).detach(),
        "wm/reward_ce": (-share * torch.sum(rew_log_lh) / denom).detach(),
        "wm/cont_ce": (share * torch.sum(cont_nll) / denom).detach(),
    }
    return total, metrics


def wm_loss(rssm: RSSM, obs_u8: Tensor, actions: Tensor, rewards: Tensor, conts: Tensor,
            gumbel: Tensor, cfg: DreamerConfig, firsts: Optional[Tensor] = None,
            plan: Optional[MeshPlan] = None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The total loss and metrics on one batch (``world_model.py:148-190``):
    obs_u8 (B, T, H, W, 3) uint8, actions (B, T, A), rewards (B, T) symlog,
    conts (B, T), ``firsts`` (B, T) the ring's episode-start channel (under
    ``env.next_step_autoreset``); gumbel (horizon, B, rows, classes)."""
    H = cfg.train.horizon
    obs_u8, actions = obs_u8[:, :H], actions[:, :H]
    rewards, conts = rewards[:, :H], conts[:, :H]

    is_first = valid_mask = None
    if firsts is not None:
        f = firsts[:, :H]
        is_first = f.clone()
        is_first[:, 0] = 0.0
        valid_mask = 1.0 - f[:, 1:]
    elif cfg.wm.reset_on_episode_start:
        is_first = torch.cat([torch.zeros_like(conts[:, :1]), 1.0 - conts[:, :-1]], dim=1)
    with record_function("wm_update/observe"):
        seq = rssm.observe_sequence(obs_u8, actions, gumbel, is_first)
    with record_function("wm_update/heads"):
        prior_logits = rssm.prior_logits(seq.h)
        dec_mu = rssm.decode(seq.h, seq.z)
        rew_logits = rssm.reward_logits(seq.h[:, 1:], seq.z[:, 1:])
        cont_logits = rssm.cont_logit(seq.h[:, 1:], seq.z[:, 1:]).squeeze(-1)
    # The target: the frames normalised as the encoder read them.
    obs = rssm.nets.train_norm[obs_u8.long()]
    buckets = bucket_values(cfg.wm.reward_buckets, device=rew_logits.device)
    return wm_loss_terms(seq.post_logits, prior_logits, dec_mu, rew_logits, cont_logits, obs,
                         rewards, conts, buckets, cfg, valid_mask=valid_mask, plan=plan)


def wm_update(rssm: RSSM, opt: AdamW, state: WMTrainState, batch: Sequence[Tensor],
              gumbel: Tensor, cfg: DreamerConfig, plan: Optional[MeshPlan] = None
              ) -> Tuple[WMTrainState, Dict[str, Tensor]]:
    """One update (``world_model.py:193-223``) of ``state.nets`` (the module
    ``rssm`` runs) on ``batch`` = (obs_u8, actions, rewards, conts[,
    firsts]).  Writes the new parameters and AdamW state in place and returns
    ``state`` with the metrics (this rank's, under ``plan``)."""
    obs, actions, rewards, conts = batch[:4]
    firsts = batch[4] if len(batch) > 4 else None
    names, params = zip(*state.nets.named_parameters())
    loss, metrics = wm_loss(rssm, obs, actions, rewards, conts, gumbel, cfg, firsts=firsts,
                            plan=plan)
    debug = cfg.runtime.debug_nans
    if debug:
        check_finite("wm update", ((k, metrics[k]) for k in LOSS_TERMS))
    with record_function("wm_update/backward"):
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    finite = torch.isfinite(loss.detach())
    if plan is not None:
        grads, finite = plan.reduce_update(grads, finite)
    with torch.no_grad(), record_function("wm_update/adamw"):
        new, opt_state = adamw_update(opt, [p.detach() for p in params], grads, state.opt)
        if debug:
            check_finite("wm update",
                         [*((f"the gradient of {k}", g) for k, g in zip(names, grads)),
                          *((f"the updated {k}", p) for k, p in zip(names, new))])
        metrics["wm/grad_norm"] = global_norm(grads)
        metrics["wm/update_skipped"] = (~finite).float()
        for dst, src in ((state.opt.mu, opt_state.mu), (state.opt.nu, opt_state.nu),
                         ([state.opt.count], [opt_state.count])):
            for d, s in zip(dst, src):
                d.copy_(torch.where(finite, s, d))
        sharded = write_update(params, new, state.opt.blocks, finite)
        if sharded:
            plan.gather_weights(sharded)
    return state, metrics
