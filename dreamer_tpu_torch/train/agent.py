"""The actor-critic update (``dreamer_tpu/train/agent.py:48-236``): warm start,
H-step imagination, lambda-returns from the target critic, REINFORCE and
twohot-critic losses, two AdamWs, the return-scale EMA, the target critic's
soft update and the skip of a non-finite update.

Semantics, as in JAX:

- the warm start's (z0, h0) and the returns R are stop-gradient; the critic
  reads stop-gradient states; the actor's gradient flows through the dream
  (mu, sigma of every step) and the frozen world model;
- advantage = sg(R - v[:, :-1]); log pi of the stop-gradient action; entropy
  -log pi, or the base Normal's under ``agent.analytic_entropy``;
- the return scale S is updated before it normalises the advantage, and
  also on a skipped step;
- a non-finite actor or critic loss skips both optimizer steps and the
  target update: every parameter and optimizer-state tensor takes
  ``torch.where(finite, new, old)``, with no host sync; under
  ``runtime.debug_nans`` the update raises ``FloatingPointError`` first,
  naming the actor or critic update and the loss term, gradient or updated
  parameter (``train.debug``).

Under a ``plan`` (``parallel.MeshPlan``) the batch is this rank's data
block of rows: the return scale's P95 - P05 is taken over every data
block's returns (``MeshPlan.gather``), the gradients are averaged and the
update skipped on every rank where any rank's loss is not finite
(``MeshPlan.reduce_update``), so the update is that of the whole batch.
Under the model axis a rank computes the step of its block of each sharded
weight (``AdamState.blocks``, ``adamw_update``), and ``MeshPlan.gather_weights``
writes every rank's blocks of the actor, the critic and the target critic.

The noise is an argument (``ACNoise``): the warm start's gumbels, the dream's
normal eps and gumbels.  ``Trainer`` draws it from the caller's generator;
tests pass the noise JAX draws from its keys.  The phases of an update are
``torch.profiler`` ranges (``ac_update/warm_start``, ``/imagine``,
``/backward``, ``/adamw``; the losses are the rest).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.core.dists import normal_entropy, tanh_normal_logprob
from dreamer_tpu_torch.core.math import bucket_values, symlog, twohot, twohot_expectation
from dreamer_tpu_torch.core.returns import lambda_returns, update_return_scale
from dreamer_tpu_torch.parallel.sharding import Block, MeshPlan
from dreamer_tpu_torch.rssm.rssm import RSSM
from dreamer_tpu_torch.train.debug import check_finite
from dreamer_tpu_torch.train.state import ACTrainState, AdamState

Tensor = torch.Tensor

# The loss terms ``runtime.debug_nans`` checks, by the update they belong to.
DEBUG_LOSS_TERMS = (("actor update", ("ac/return_mean", "ac/return_scale", "ac/adv_std",
                                      "ac/entropy", "ac/loss_actor")),
                    ("critic update", ("ac/value_mean", "ac/loss_critic")))


class ACNoise(NamedTuple):
    """The noise of one update (JAX splits its key into k_warm, k_dream)."""

    warm: Tensor   # (Tw, B, rows, classes) gumbels of the warm start's samples
    eps: Tensor    # (H, B, A) standard normals of the dream's actions
    gum: Tensor    # (H, B, rows, classes) gumbels of the dream's latents


class AdamW(NamedTuple):
    """optax ``chain(clip_by_global_norm(clip), adamw(lr, b1, b2, eps, wd))``."""

    lr: float
    b1: float
    b2: float
    eps: float
    weight_decay: float
    clip: float


def global_norm(tensors: Sequence[Tensor]) -> Tensor:
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


def adamw_update(opt: AdamW, params: Sequence[Tensor], grads: Sequence[Tensor],
                 state: AdamState) -> Tuple[List[Tensor], AdamState]:
    """One optimizer step as optax computes it; returns the new parameters and
    state without writing anything:

        g <- g if |g| < clip else g / |g| * clip   (global norm)
        mu <- (1 - b1) g + b1 mu;  nu <- (1 - b2) g^2 + b2 nu;  count += 1
        p <- p + (-lr) (mu / (1 - b1^count) / (sqrt(nu / (1 - b2^count)) + eps) + wd p)

    Under the model axis (``state.blocks``) the norm is the whole gradient's,
    and a sharded parameter's new value is of this rank's block only: the
    step is elementwise but for the norm, so the blocks are one process's."""
    g_norm = global_norm(grads)
    trigger = g_norm < opt.clip
    if state.blocks is not None:
        params = [p if b is None else b.of(p) for p, b in zip(params, state.blocks)]
        grads = [g if b is None else b.of(g) for g, b in zip(grads, state.blocks)]
    grads = [torch.where(trigger, g, (g / g_norm) * opt.clip) for g in grads]
    mu = [(1 - opt.b1) * g + opt.b1 * m for g, m in zip(grads, state.mu)]
    nu = [(1 - opt.b2) * g ** 2 + opt.b2 * v for g, v in zip(grads, state.nu)]
    count = torch.where(state.count < torch.iinfo(torch.int32).max, state.count + 1,
                        state.count)
    c = count.float()
    bc1 = 1 - torch.pow(torch.tensor(opt.b1, device=c.device), c)
    bc2 = 1 - torch.pow(torch.tensor(opt.b2, device=c.device), c)
    new = []
    for p, m, v in zip(params, mu, nu):
        u = (m / bc1) / (torch.sqrt(v / bc2) + opt.eps) + opt.weight_decay * p
        new.append(p + (-opt.lr) * u)
    return new, AdamState(mu=mu, nu=nu, count=count, blocks=state.blocks)


def write_update(params: Sequence[Tensor], new: Sequence[Tensor],
                 blocks: Optional[Sequence[Optional[Block]]], finite: Tensor
                 ) -> List[Tuple[Tensor, Block, Tensor]]:
    """Write ``new`` into ``params`` where ``finite`` (the old value where
    not: ``torch.where``, no host sync).  A parameter that ``blocks`` shards
    is not written here: its block's value is returned as (parameter, block,
    value), for ``MeshPlan.gather_weights`` to write every rank's block."""
    sharded = []
    for p, s, b in zip(params, new, blocks or [None] * len(params), strict=True):
        if b is None:
            p.copy_(torch.where(finite, s, p))
        else:
            sharded.append((p, b, torch.where(finite, s, b.of(p))))
    return sharded


class AgentTrainer:
    """The actor-critic losses and update on a frozen world model."""

    def __init__(self, cfg: DreamerConfig):
        a = cfg.agent
        self.cfg = cfg
        self.actor_opt = AdamW(a.actor_lr, a.actor_betas[0], a.actor_betas[1], a.actor_eps,
                               a.weight_decay, a.grad_clip)
        self.critic_opt = AdamW(a.critic_lr, a.critic_betas[0], a.critic_betas[1],
                                a.critic_eps, a.weight_decay, a.grad_clip)

    def buckets(self, device) -> Tensor:
        return bucket_values(self.cfg.agent.critic_buckets, device=device)

    def critic_value(self, critic, h: Tensor, z: Tensor) -> Tensor:
        """symexp(E[twohot]) value, (...)."""
        logits = critic(h, z)
        return twohot_expectation(logits, self.buckets(logits.device)).squeeze(-1)

    def ac_loss(self, state: ACTrainState, rssm: RSSM, obs_u8: Tensor, actions: Tensor,
                noise: ACNoise, conts: Optional[Tensor] = None,
                nu: Optional[Tensor] = None, firsts: Optional[Tensor] = None,
                plan: Optional[MeshPlan] = None) -> Tuple[Tensor, Dict[str, Tensor]]:
        """(actor loss + critic loss, metrics) on one replay batch
        (``agent.py:104-190``).  obs_u8 (B, T', H, W, 3) uint8 and actions
        (B, T', A) with T' >= sequence_length // 2; ``conts`` feeds the warm
        start's episode resets under ``wm.reset_on_episode_start`` and
        ``firsts`` (the ring's episode-start channel) takes precedence."""
        cfg = self.cfg
        Tw = cfg.train.sequence_length // 2
        is_first = None
        if firsts is not None:
            is_first = firsts[:, :Tw].clone()
            is_first[:, 0] = 0.0
        elif cfg.wm.reset_on_episode_start and conts is not None:
            c = conts[:, :Tw]
            is_first = torch.cat([torch.zeros_like(c[:, :1]), 1.0 - c[:, :-1]], dim=1)
        with torch.no_grad(), record_function("ac_update/warm_start"):
            z0, h0 = rssm.warm_start(obs_u8[:, :Tw], actions[:, :Tw], noise.warm, is_first)
        with record_function("ac_update/imagine"):
            traj = rssm.imagine(state.actor, z0, h0, noise.eps, noise.gum, cfg.agent.min_std)
        h_sg, z_sg = traj.h.detach(), traj.z.detach()
        with torch.no_grad():
            values_t = self.critic_value(state.target_critic, h_sg, z_sg)
            R = lambda_returns(values_t, traj.reward, traj.cont, cfg.agent.gamma,
                               cfg.agent.lambda_)

        logits_all = state.critic(h_sg, z_sg)
        v = twohot_expectation(logits_all.detach(), self.buckets(R.device)).squeeze(-1)
        advantage = R - v[:, :-1]
        logp = tanh_normal_logprob(traj.action.detach(), traj.mu, traj.sigma)
        entropy = normal_entropy(traj.sigma) if cfg.agent.analytic_entropy else -logp
        s_new = update_return_scale(state.s_scale, R if plan is None else plan.gather(R),
                                    cfg.agent.s_ema)
        norm = torch.clamp(s_new, min=1.0).detach()
        nu_val = cfg.agent.nu if nu is None else nu
        loss_actor = torch.mean(-logp * (advantage / norm) - nu_val * entropy)

        target = twohot(symlog(R), self.buckets(R.device))
        logp_v = F.log_softmax(logits_all[:, :-1].float(), dim=-1)
        loss_critic = torch.mean(-torch.sum(target * logp_v, dim=-1))

        aux = {
            "ac/loss_actor": loss_actor.detach(),
            "ac/loss_critic": loss_critic.detach(),
            "ac/entropy": entropy.detach().mean(),
            "ac/return_mean": R.mean(),
            "ac/return_scale": s_new,
            "ac/value_mean": v.mean(),
            "ac/adv_std": advantage.std(correction=0),
            "ac/imag_reward_mean": traj.reward.mean(),
            "ac/imag_cont_mean": traj.cont.mean(),
            "_s_new": s_new,
            "_loss_actor": loss_actor,
            "_loss_critic": loss_critic,
        }
        return loss_actor + loss_critic, aux

    def ac_update(self, state: ACTrainState, rssm: RSSM, batch: Sequence[Tensor],
                  noise: ACNoise, nu: Optional[Tensor] = None, plan: Optional[MeshPlan] = None
                  ) -> Tuple[ACTrainState, Dict[str, Tensor]]:
        """One update (``agent.py:192-236``) on ``batch`` = (obs_u8, actions[,
        rewards, conts[, firsts]]).  Writes the new parameters and optimizer
        states into ``state`` in place and returns it with the metrics."""
        obs, actions = batch[0], batch[1]
        conts = batch[3] if len(batch) > 3 else None
        firsts = batch[4] if len(batch) > 4 else None
        actor_n, actor_p = zip(*state.actor.named_parameters())
        critic_n, critic_p = zip(*state.critic.named_parameters())
        actor_p, critic_p = list(actor_p), list(critic_p)
        _, aux = self.ac_loss(state, rssm, obs, actions, noise, conts=conts, nu=nu,
                              firsts=firsts, plan=plan)
        s_new = aux.pop("_s_new")
        loss_actor, loss_critic = aux.pop("_loss_actor"), aux.pop("_loss_critic")
        debug = self.cfg.runtime.debug_nans
        if debug:
            for where, keys in DEBUG_LOSS_TERMS:
                check_finite(where, ((k, aux[k]) for k in keys))
        with record_function("ac_update/backward"):
            grads = torch.autograd.grad(loss_actor + loss_critic, actor_p + critic_p,
                                        allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(actor_p + critic_p, grads)]
        g_actor, g_critic = grads[:len(actor_p)], grads[len(actor_p):]
        finite = torch.isfinite(loss_actor.detach()) & torch.isfinite(loss_critic.detach())
        if plan is not None:
            grads, finite = plan.reduce_update(grads, finite)
            g_actor, g_critic = grads[:len(actor_p)], grads[len(actor_p):]

        with torch.no_grad(), record_function("ac_update/adamw"):
            old_a, old_c = [p.detach() for p in actor_p], [p.detach() for p in critic_p]
            new_a, a_opt = adamw_update(self.actor_opt, old_a, g_actor, state.actor_opt)
            new_c, c_opt = adamw_update(self.critic_opt, old_c, g_critic, state.critic_opt)
            tau = self.cfg.agent.target_tau
            target_p = list(state.target_critic.parameters())
            # The target critic shards as the critic does (the same shapes).
            c_blocks = state.critic_opt.blocks or [None] * len(target_p)
            new_t = [(1.0 - tau) * (t if b is None else b.of(t)) + tau * c
                     for t, c, b in zip(target_p, new_c, c_blocks)]
            if debug:
                for where, names, g, p in (("actor update", actor_n, g_actor, new_a),
                                           ("critic update", critic_n, g_critic, new_c)):
                    check_finite(where, [*((f"the gradient of {k}", v) for k, v in zip(names, g)),
                                         *((f"the updated {k}", v) for k, v in zip(names, p))])
                check_finite("critic update", ((f"the updated target {k}", v)
                                               for k, v in zip(critic_n, new_t)))
            aux["ac/grad_norm_actor"] = global_norm(g_actor)
            aux["ac/grad_norm_critic"] = global_norm(g_critic)
            aux["ac/update_skipped"] = (~finite).float()
            for dst, src in ((state.actor_opt.mu, a_opt.mu), (state.actor_opt.nu, a_opt.nu),
                             (state.critic_opt.mu, c_opt.mu),
                             (state.critic_opt.nu, c_opt.nu),
                             ([state.actor_opt.count], [a_opt.count]),
                             ([state.critic_opt.count], [c_opt.count])):
                for d, s in zip(dst, src):
                    d.copy_(torch.where(finite, s, d))
            sharded = (write_update(actor_p, new_a, state.actor_opt.blocks, finite)
                       + write_update(critic_p, new_c, state.critic_opt.blocks, finite)
                       + write_update(target_p, new_t, state.critic_opt.blocks, finite))
            if sharded:
                plan.gather_weights(sharded)
            state.s_scale.copy_(s_new)
        return state, aux
