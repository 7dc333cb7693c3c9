"""The programs of ``dreamer_tpu/train/step.py``: ``Policy``, the per-env-step
act/observe calls of rollout and eval, batched over N envs (``:194-247``);
and ``Trainer``, the learner: ``wm_step`` (``:131-149``), ``ac_step``
(``:151-178``) and the whole iteration ``train_iteration`` (``:180-188``).

Both hold the world-model nets (through ``RSSM``) and draw their noise from
the caller's ``torch.Generator`` (``sample_noise``, ``sample_wm_noise``,
``sample_ac_noise``); tests pass the noise JAX draws instead.  On a CUDA
device the encoder, the GRU cell, the whole-scan GRU and the imagination run
as the hand-written kernels of ``dreamer_tpu_torch.ops``; those take
bfloat16, so the card needs ``runtime.compute_dtype: bfloat16``.

The mesh (``runtime.mesh_shape = [n, m]``): a ``Trainer`` built with a
``parallel.MeshPlan`` is one rank of n x m.  ``cfg.env.num_envs`` is the
global env count; the rank's ring holds its data index's env block
(``init_ring``), as does every rank of its model group.  Every rank draws
the whole batch's indices and noise from a generator seeded alike on every
rank, keeps its data block of rows, and the plan's collectives make the
ranks' updates one update of the whole batch; under m > 1 a rank keeps the
moments of its block of each sharded weight (``AdamState.blocks``).  A
``Trainer(..., n_shards=n)`` without a plan is that update in one process:
the same draws over the whole ring.
"""

from __future__ import annotations

import copy
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.core.dists import sample_gumbel
from dreamer_tpu_torch.nets.actor_critic import Actor, Critic
from dreamer_tpu_torch.nets.wm_nets import WMNets
from dreamer_tpu_torch.parallel.sharding import MeshPlan
from dreamer_tpu_torch.replay.buffer import ReplayBuffer, ReplayState
from dreamer_tpu_torch.rssm.rssm import RSSM
from dreamer_tpu_torch.train.agent import ACNoise, AgentTrainer
from dreamer_tpu_torch.train.debug import check_finite
from dreamer_tpu_torch.train.state import ACTrainState, AdamState, DreamerState, WMTrainState
from dreamer_tpu_torch.train.world_model import make_wm_optimizer, wm_update

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
    def __init__(self, cfg: DreamerConfig, device=None, seed: int = 0,
                 nets: Optional[WMNets] = None, actor: Optional[Actor] = None):
        """Act with ``nets`` (``WMNets``) and ``actor`` themselves when both
        are given, not copies, on their device and in their dtype: a
        learner's in-place updates reach the policy at once, and the kernel
        layouts follow by their version stamps.  Otherwise build the nets at
        ``cfg``'s widths with weights drawn from ``seed`` (on the CPU, so
        every device gets the same weights) and move them to ``device``."""
        self.cfg = cfg
        if (nets is None) != (actor is None):
            raise ValueError("Policy takes both nets and actor, or neither")
        if nets is None:
            self.device = resolve_device(device)
            self.dtype = getattr(torch, cfg.runtime.compute_dtype)
            gen = torch.Generator().manual_seed(seed)
            nets = WMNets(cfg.wm, cfg.env.action_dim, self.dtype, gen).to(self.device)
            a = cfg.agent
            actor = Actor(cfg.wm.hidden_dim + cfg.wm.latent_dim, cfg.env.action_dim,
                          a.actor_hidden_1, a.actor_hidden_2, a.min_std, self.dtype,
                          gen).to(self.device)
            nets.prepare_kernels()
        else:
            self.device = next(nets.parameters()).device
            self.dtype = nets.dtype
        self.rssm = RSSM(cfg.wm, cfg.env.action_dim, self.dtype, nets=nets)
        self.actor = actor

    def sample_noise(self, n: int, generator: torch.Generator) -> PolicyNoise:
        """Draw one step's noise for ``n`` envs on the policy's device."""
        c = self.cfg.wm
        shape = (n, c.latent_rows, c.latent_classes)
        return PolicyNoise(
            sample_gumbel(shape, generator, self.device),
            sample_gumbel(shape, generator, self.device),
            torch.randn(n, self.cfg.env.action_dim, generator=generator, device=self.device))

    def _check(self, **named: Tensor) -> None:
        """Under ``runtime.debug_nans``, raise ``FloatingPointError`` naming
        the first of ``named`` that is not finite."""
        if self.cfg.runtime.debug_nans:
            check_finite("policy step", named.items())

    @torch.no_grad()
    def policy_reset(self, obs_u8: Tensor, gumbel: Tensor) -> Tuple[Tensor, Tensor]:
        """Episode-start state: h = 0, z = encode(h=0, obs).  obs_u8 (N, H, W, 3)."""
        h = torch.zeros(obs_u8.shape[0], self.cfg.wm.hidden_dim, device=obs_u8.device)
        z = self.rssm.encode_initial(obs_u8, gumbel, h)
        self._check(z=z)
        return h, z

    @torch.no_grad()
    def policy_act(self, h: Tensor, z: Tensor, eps: Optional[Tensor] = None,
                   deterministic: bool = False) -> Tensor:
        """tanh(mu) if deterministic, else tanh(mu + sigma * eps)."""
        mu, sigma = self.actor(h, z)
        action = torch.tanh(mu) if deterministic else torch.tanh(mu + sigma * eps)
        self._check(action=action)
        return action

    @torch.no_grad()
    def policy_observe(self, z: Tensor, h: Tensor, action: Tensor, obs_u8: Tensor,
                       gumbel: Tensor) -> Tuple[Tensor, Tensor]:
        """Posterior step after an env transition.  Returns (z', h')."""
        z2, h2, _ = self.rssm.observe_step(z, h, action, obs_u8, gumbel)
        self._check(h=h2, z=z2)
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
        self._check(h=h_next, z=z_next)
        action = self.policy_act(h_next, z_next, noise.eps, deterministic)
        return h_next, z_next, action


class Trainer:
    """The learner: the world model (``self.rssm.nets``, which the state's
    ``wm.nets`` is) and the actor-critic, each updated in place."""

    def __init__(self, cfg: DreamerConfig, device=None, seed: int = 0,
                 plan: Optional[MeshPlan] = None, n_shards: int = 1):
        """Build the world-model nets at ``cfg``'s widths with weights drawn
        from ``seed`` (on the CPU) and move them to ``device``.  ``plan``
        makes this trainer one rank of its mesh; without one, ``n_shards``
        draws the batches as that many data shards would."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.plan = plan
        self.n_shards = n_shards if plan is None else plan.n_data
        # This rank's shard (its data index) and rows of every batch (all of
        # them without a plan).
        self.shard = None if plan is None else plan.data_index
        self.rows = slice(None) if plan is None else plan.row_block(cfg.train.batch_size)
        self.dtype = getattr(torch, cfg.runtime.compute_dtype)
        self.seed = seed
        gen = torch.Generator().manual_seed(seed)
        self.rssm = RSSM(cfg.wm, cfg.env.action_dim, self.dtype, gen)
        self.rssm.nets.to(self.device)
        self.rssm.nets.prepare_kernels()
        self.agent = AgentTrainer(cfg)
        self.wm_opt = make_wm_optimizer(cfg)
        self.buffer = ReplayBuffer(cfg.train.buffer_size, cfg.train.sequence_length,
                                   cfg.env.action_dim, cfg.wm.obs_size,
                                   num_envs=cfg.env.num_envs,
                                   store_firsts=cfg.env.next_step_autoreset)

    def init_ring(self) -> ReplayState:
        """An empty ring on the trainer's device: this rank's env block under
        a plan, else every env."""
        return self.buffer.init_state(self.device, 1 if self.plan is None else self.n_shards)

    def _sample(self, ring: ReplayState, generator: torch.Generator, **kw):
        """This rank's rows of a batch drawn as ``n_shards`` shards draw it."""
        return self.buffer.sample(ring, self.cfg.train.batch_size, generator,
                                  n_shards=self.n_shards, shard=self.shard, **kw)

    def _global(self, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return metrics if self.plan is None else self.plan.mean_metrics(metrics)

    def _blocks(self, module):
        """This rank's blocks of ``module``'s weights under the model axis."""
        return None if self.plan is None else self.plan.param_blocks(module)

    def init_state(self) -> DreamerState:
        """The whole training state (``step.py:85-104``): the world model with
        a fresh AdamW state; actor and critic drawn from the trainer's seed +
        1 (on the CPU), the target critic a copy of the critic, fresh AdamW
        states and ``s_scale = 1``; step 0.  Under the model axis a sharded
        weight's moments are of this rank's block (``AdamState.blocks``)."""
        cfg, a = self.cfg, self.cfg.agent
        gen = torch.Generator().manual_seed(self.seed + 1)
        in_dim = cfg.wm.hidden_dim + cfg.wm.latent_dim
        actor = Actor(in_dim, cfg.env.action_dim, a.actor_hidden_1, a.actor_hidden_2,
                      a.min_std, self.dtype, gen).to(self.device)
        critic = Critic(in_dim, a.critic_buckets, a.critic_hidden_1, a.critic_hidden_2,
                        self.dtype, gen).to(self.device)
        target = copy.deepcopy(critic).requires_grad_(False)
        ac = ACTrainState(actor=actor, critic=critic, target_critic=target,
                          actor_opt=AdamState.zeros_like(actor, self._blocks(actor)),
                          critic_opt=AdamState.zeros_like(critic, self._blocks(critic)),
                          s_scale=torch.ones((), device=self.device))
        wm = WMTrainState(nets=self.rssm.nets, opt=AdamState.zeros_like(
            self.rssm.nets, self._blocks(self.rssm.nets)))
        return DreamerState(wm=wm, ac=ac,
                            step=torch.zeros((), dtype=torch.int32, device=self.device))

    def sample_wm_noise(self, batch_size: int, generator: torch.Generator) -> torch.Tensor:
        """One world-model update's noise on the trainer's device: the
        posterior scan's gumbels (horizon, B, rows, classes)."""
        c = self.cfg.wm
        return sample_gumbel((self.cfg.train.horizon, batch_size, c.latent_rows,
                              c.latent_classes), generator, self.device)

    def sample_ac_noise(self, batch_size: int, generator: torch.Generator) -> ACNoise:
        """One update's noise on the trainer's device."""
        c, t = self.cfg.wm, self.cfg.train
        lat = (batch_size, c.latent_rows, c.latent_classes)
        return ACNoise(
            warm=sample_gumbel((t.sequence_length // 2, *lat), generator, self.device),
            eps=torch.randn(t.horizon, batch_size, self.cfg.env.action_dim,
                            generator=generator, device=self.device),
            gum=sample_gumbel((t.horizon, *lat), generator, self.device))

    def wm_step(self, state: DreamerState, ring: ReplayState, generator: torch.Generator
                ) -> Tuple[DreamerState, Dict[str, torch.Tensor]]:
        """``train.wm_epochs`` world-model updates, each on a fresh sample of
        the first ``horizon`` steps of B windows with its own noise; the
        metrics are the last epoch's, with every epoch's loss as
        ``wm/loss_epochs`` (``step.py:131-149``), global means under a plan.
        The indices and the noise come from ``generator``, which must live on
        the trainer's device."""
        cfg = self.cfg
        per_epoch = []
        for _ in range(cfg.train.wm_epochs):
            batch = self._sample(ring, generator, t_out=cfg.train.horizon)
            gumbel = self.sample_wm_noise(cfg.train.batch_size, generator)[:, self.rows]
            _, metrics = wm_update(self.rssm, self.wm_opt, state.wm, batch,
                                   gumbel.contiguous(), cfg, plan=self.plan)
            per_epoch.append(metrics)
        metrics = dict(per_epoch[-1])
        metrics["wm/loss_epochs"] = torch.stack([m["wm/loss"] for m in per_epoch])
        return state, self._global(metrics)

    def ac_step(self, state: DreamerState, ring: ReplayState, generator: torch.Generator,
                nu: Optional[torch.Tensor] = None
                ) -> Tuple[DreamerState, Dict[str, torch.Tensor]]:
        """``train.ac_epochs`` actor-critic updates, each on a fresh sample of
        the first ``sequence_length // 2`` steps of B windows (the warm
        start's), with the metrics averaged over the epochs as ``_ac_step``
        does (global means under a plan).  The indices and the noise come from
        ``generator``, which must live on the trainer's device."""
        cfg = self.cfg
        with_scalars = cfg.wm.reset_on_episode_start or cfg.env.next_step_autoreset
        per_epoch = []
        for _ in range(cfg.train.ac_epochs):
            batch = self._sample(ring, generator, t_out=cfg.train.sequence_length // 2,
                                 with_scalars=with_scalars)
            noise = self.sample_ac_noise(cfg.train.batch_size, generator)
            noise = ACNoise(*(n[:, self.rows].contiguous() for n in noise))
            _, metrics = self.agent.ac_update(state.ac, self.rssm, batch, noise, nu,
                                              plan=self.plan)
            per_epoch.append(metrics)
        return state, self._global(
            {k: torch.stack([m[k] for m in per_epoch]).mean() for k in per_epoch[0]})

    def train_iteration(self, state: DreamerState, ring: ReplayState,
                        generator: torch.Generator, nu: Optional[torch.Tensor] = None
                        ) -> Tuple[DreamerState, Dict[str, torch.Tensor]]:
        """One learner iteration (``step.py:180-188``): ``wm_step``, then
        ``ac_step`` on the updated world model, then ``step + 1``."""
        state, wm_metrics = self.wm_step(state, ring, generator)
        state, ac_metrics = self.ac_step(state, ring, generator, nu)
        state.step += 1
        return state, {**wm_metrics, **ac_metrics}
