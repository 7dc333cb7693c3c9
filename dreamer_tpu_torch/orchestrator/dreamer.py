"""The Dreamer orchestrator: the train / eval / run lifecycle of
``dreamer_tpu/orchestrator/dreamer.py`` on one device (the card by default).

Host responsibilities only: env stepping, replay writes, eval cadence,
checkpoints and metrics.  The compute is the ``Trainer``'s (``wm_step``,
``train_iteration``) and the ``Policy``'s (one ``policy_act_observe`` call
per env step).  By default the policy acts on the learner's own modules, in
the compute dtype and through the card's kernels, so every round rolls out
with the weights of the last update.  With ``runtime.rollout_device='cpu'``
(the host-local actor, JAX's ``dreamer.py:322-405``) it acts in float32 on
a copy of its own on the CPU, refreshed before a round or an eval whenever
the learner's weights have changed: one device-to-host copy of every
world-model and actor parameter, cast to ``runtime.broadcast_dtype`` on the
learner's device first (``broadcast``); rollout and eval then make no CUDA
call, and a round's one ring write is the only host-to-device traffic.
``runtime.async_rollout`` (which needs the host-local actor) collects the
next round on a thread while the learner updates on the ring as it stood
before that round, then writes the round: one round of staleness, as JAX's
``dreamer.py:981-1050``.

Lifecycle (``train``):
  kickstart — ``train.random_iterations`` rounds of random-policy rollout,
              each followed by a world-model step; an eval; a checkpoint
  training  — ``train.training_iterations`` iterations of one policy
              rollout round and one ``train_iteration``; checkpoints every
              ``checkpoint_every``, evals every ``eval_every``
  final     — a ``final_eval_episodes`` eval and a checkpoint

The rollout keeps its recurrent state, action and frame across rounds (reset
only at episode ends).  Randomness comes from two ``torch.Generator``: the
learner's (replay draws, update noise) on the learner's device, seeded from
``train.seed``, and the rollout's (policy noise) on the policy's device,
from ``train.seed + 1``; both are checkpointed, and a resume whose saved
states come from another device type reseeds both from ``train.seed`` and
the restored iteration.  ``runtime.async_checkpoint`` snapshots the
checkpoint to host memory and writes it on a thread
(``utils.checkpoint``); the run waits for it before a stop returns and at
the end of the schedule.  Under ``runtime.debug_nans`` an update or policy
step that meets a non-finite value raises ``FloatingPointError`` naming it
and the iteration.

The envs: ``env_factory``, or ``envs.make_env`` for ``env.env_id`` over the
base-env maker ``env_maker`` (``"module:function"``, e.g. ``gymnasium:make``;
``"fake"`` needs none).  Rollout steps them in the in-process ``EnvFarm``,
or with ``env.async_envs`` in ``AsyncEnvFarm``'s spawned workers; eval
always in process.

Data parallelism (``runtime.mesh_shape = [n, 1]``, JAX's multi-process
path): one rank a process, joined by ``parallel.init_distributed`` (the CLI
calls it).  ``env.num_envs`` is the envs of a host; the global farm is that
times the hosts (``WORLD_SIZE / LOCAL_WORLD_SIZE``), and each rank steps its
block of it with its own env seeds (``train.seed + rank * 100_003``) and
rollout stream, and keeps their ring.  The learner is one update of the
global batch on every rank (``Trainer`` with a ``MeshPlan``).  Rank 0
decides a stop and runs every eval, and the others take its flag and
reward; rank 0 alone writes metrics, ``run_meta.json``, ``kickstart.json``,
``best.json`` and ``agent_best``, and the checkpoint's state, beside every
rank's ring shard (``utils.checkpoint``).  More than one rank needs the
host-local actor (``runtime.rollout_device='cpu'``), as in JAX.

Differences from the JAX orchestrator:
- Without the host-local actor the rollout and eval policy computes in the
  config's compute dtype, through the kernels on the card; JAX runs it in
  float32 (``dreamer.py:54-62``).  Under a float32 config, on the same
  weights and noise, the rollout ring and the eval actions agree with JAX's
  to 1e-5 (``tests/test_torch_orchestrator_policy.py``); the host-local actor
  acts in float32 as JAX's does (``tests/test_torch_actor_learner.py``).
- One device a rank.  A model axis in ``runtime.mesh_shape`` raises a
  ``ValueError`` naming the ROADMAP item that will bring it; so does a
  compute dtype other than bfloat16 on a CUDA device, whose kernels take
  bf16 only.
- The rollout stream of rank r is seeded ``train.seed + 1 + r * 100_003``
  (JAX folds the process index into its key).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.core.dists import sample_gumbel
from dreamer_tpu_torch.envs import AsyncEnvFarm, EnvFarm, make_env, missing_maker_message
from dreamer_tpu_torch.orchestrator import broadcast
from dreamer_tpu_torch.parallel import MeshPlan, distributed, make_mesh, refuse_model_axis
from dreamer_tpu_torch.train.state import AdamState
from dreamer_tpu_torch.train.step import Policy, Trainer, resolve_device
from dreamer_tpu_torch.utils import CheckpointManager, MetricsLogger
from dreamer_tpu_torch.utils.checkpoint import atomic_save, load


# A resume whose generator states come from the other device type reseeds
# both streams from train.seed + RESEED_STRIDE * (iteration + 1), the rollout's
# one above the learner's.
RESEED_STRIDE = 1_000_003
# Rank r's env seeds and rollout stream are offset by r times this.
RANK_SEED_STRIDE = 100_003


def refuse_unported(cfg: DreamerConfig, device: torch.device) -> None:
    """Raise ``ValueError`` for a setting the port does not run yet, for an
    overlapped rollout without the host-local actor (as JAX does), and for
    a compute dtype the card's kernels do not take."""
    r = cfg.runtime
    if r.mesh_shape is not None:
        refuse_model_axis(int(r.mesh_shape[1]))
    if r.async_rollout and r.rollout_device != "cpu":
        raise ValueError("runtime.async_rollout requires runtime.rollout_device='cpu' (the "
                         "actor must not read the learner's weights while they are updated)")
    if device.type == "cuda" and r.compute_dtype != "bfloat16":
        raise ValueError(
            f"runtime.compute_dtype={r.compute_dtype!r} on a CUDA device: the card's kernels "
            "(the GRU cell, the whole-scan GRU, the conv encoder and the imagination) take "
            "bfloat16 only; set runtime.compute_dtype=bfloat16, or run on the CPU "
            "(--device cpu)")


def _adam_tree(opt: AdamState) -> Dict[str, object]:
    return {"mu": list(opt.mu), "nu": list(opt.nu), "count": opt.count}


def _copy_into(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    if tuple(dst.shape) != tuple(src.shape) or dst.dtype != src.dtype:
        raise ValueError(f"checkpoint: {name} is {tuple(src.shape)} {src.dtype}, the run "
                         f"holds {tuple(dst.shape)} {dst.dtype}")
    dst.copy_(src)


def _load_adam(opt: AdamState, saved: Dict[str, object], name: str) -> None:
    for kind in ("mu", "nu"):
        dst, src = getattr(opt, kind), saved[kind]
        if len(dst) != len(src):
            raise ValueError(f"checkpoint: {name}.{kind} holds {len(src)} tensors, the run "
                             f"{len(dst)}")
        for i, (d, s) in enumerate(zip(dst, src)):
            _copy_into(d, s, f"{name}.{kind}[{i}]")
    _copy_into(opt.count, saved["count"], f"{name}.count")


def metrics_to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The whole metrics dict in ONE device-to-host copy (a float() per
    scalar would wait for the device once per key)."""
    flat = [v.detach().float().reshape(-1) for v in metrics.values()]
    host = torch.cat(flat).cpu().numpy()
    out, i = {}, 0
    for (k, v), f in zip(metrics.items(), flat):
        out[k] = host[i:i + f.numel()].reshape(v.shape)
        i += f.numel()
    return out


class Dreamer:
    def __init__(self, cfg: DreamerConfig, env_factory: Optional[Callable] = None,
                 env_maker: Optional[str] = None, resuming: bool = False, device=None):
        """``device``: None for the card, or a device name (``"cpu"``).
        ``env_factory`` builds one env; by default ``make_env`` for
        ``env.env_id`` over the base-env maker ``env_maker``.
        ``resuming`` says whether this run intends to ``--resume``: it
        decides whether metrics files already in the log_dir are kept as
        earlier legs or archived as a previous run's (``MetricsLogger``)."""
        refuse_unported(cfg, torch.device("cuda" if device is None else device))
        if env_factory is None and env_maker is None and cfg.env.env_id != "fake":
            raise ValueError(f"Dreamer: {missing_maker_message(cfg.env.env_id)}")
        self.cfg = cfg
        self.device = resolve_device(device)
        # The data axis: this rank's plan, or None for one process.
        world = distributed.world_size()
        if world > 1 and not cfg.runtime.mesh_shape:
            raise ValueError(f"a run of {world} ranks needs runtime.mesh_shape (the CLI "
                             f"defaults it to [{world}, 1])")
        if world > 1 and cfg.runtime.rollout_device != "cpu":
            raise ValueError("a run of more than one rank needs runtime.rollout_device='cpu': "
                             "the rollout and eval policy must be host-local, so that only "
                             "the learner's updates are collective")
        self.plan: Optional[MeshPlan] = None
        self.rank = 0
        n_envs = cfg.env.num_envs
        learner_cfg = cfg
        if cfg.runtime.mesh_shape:
            self.plan = MeshPlan(make_mesh(*(int(n) for n in cfg.runtime.mesh_shape)),
                                 self.device)
            self.rank = self.plan.rank
            # env.num_envs is a host's: the learner spans the global farm.
            n_global = cfg.env.num_envs * distributed.hosts()
            block = self.plan.env_block(n_global)
            n_envs = block.stop - block.start
            learner_cfg = cfg.with_override(f"env.num_envs={n_global}")
        self.n_envs_global = learner_cfg.env.num_envs
        self.trainer = Trainer(learner_cfg, device=self.device, seed=cfg.train.seed,
                               plan=self.plan)
        self.state = self.trainer.init_state()
        # The host-local actor: a float32 policy of its own on the CPU, whose
        # weights come from the learner's (_refresh_actor); the stamps of the
        # learner's weights it holds, or None.
        self.host_actor = cfg.runtime.rollout_device == "cpu"
        self._actor_stamp = None
        if self.host_actor:
            self.policy = Policy(cfg.with_override("runtime.compute_dtype=float32"),
                                 device="cpu", seed=cfg.train.seed)
        else:
            self.policy = Policy(cfg, nets=self.trainer.rssm.nets, actor=self.state.ac.actor)
        # Learner stream: replay draws and update noise.  Rollout stream: the
        # policy's noise in rollout and eval, on the policy's device.
        self.rng = torch.Generator(device=self.device).manual_seed(cfg.train.seed)
        self._rank_offset = self.rank * RANK_SEED_STRIDE
        self.rollout_rng = torch.Generator(device=self.policy.device).manual_seed(
            cfg.train.seed + 1 + self._rank_offset)
        self.buf = self.trainer.init_ring()
        self.iteration = 0
        # Set by request_stop (e.g. from a SIGTERM handler): the train loop
        # finishes the current iteration, checkpoints and returns;
        # ``stopped`` records that the last train() ended that way.
        self._stop_requested = False
        self.stopped = False

        # A partial of the module-level make_env pickles for AsyncEnvFarm's
        # spawned workers.
        self._env_factory = env_factory or functools.partial(
            make_env, cfg.env.env_id, obs_size=cfg.wm.obs_size,
            action_repeat=cfg.env.action_repeat, crop_rows=cfg.env.crop_rows,
            max_episode_steps=cfg.env.max_episode_steps, base_make=env_maker)
        farm_cls = AsyncEnvFarm if cfg.env.async_envs else EnvFarm
        self.farm = farm_cls([self._env_factory] * n_envs,
                             seed=cfg.train.seed + self._rank_offset,
                             next_step=cfg.env.next_step_autoreset)
        self.eval_env = self._env_factory()
        self._eval_farm: Optional[EnvFarm] = None
        self._eval_seed = cfg.train.seed + 10_000

        # Persistent rollout state: (h, z) and the action to apply next on
        # the policy's device; the frame BEFORE that action and its
        # episode-start flags on the host.
        self._h = self._z = self._action = None
        self._obs: Optional[np.ndarray] = None
        self._first: Optional[np.ndarray] = None

        self.metrics = MetricsLogger(cfg.runtime.log_dir, resuming=resuming,
                                     enabled=self.rank == 0)
        if self.rank == 0:
            self._write_run_meta()
        self.ckpt = CheckpointManager(cfg.runtime.checkpoint_dir,
                                      use_async=cfg.runtime.async_checkpoint, plan=self.plan)
        # The best eval so far; an improvement re-exports agent_best.
        self.best_eval = float("-inf")
        # Whether the restored checkpoint carried the replay ring (drives the
        # ring-less resume's re-prime default in train()).
        self._ring_restored = False
        # Live entropy dose (runtime.traced_nu) and the nu_override file's
        # last-seen mtime.
        self._nu = float(cfg.agent.nu)
        self._nu_mtime: Optional[float] = None

    def close(self):
        """Land the last checkpoint; close the metrics file and the envs."""
        try:
            self.ckpt.close()
        finally:
            self.metrics.close()
            self.farm.close()
            self.eval_env.close()
            if self._eval_farm is not None:
                self._eval_farm.close()

    # ------------------------------------------------------------------ #
    # Kickstart progress sidecar: a graceful stop mid-kickstart checkpoints
    # at iteration 0; kickstart.json records the rounds actually done so a
    # resume runs the rest (a checkpoint without it counts as all done).
    # ------------------------------------------------------------------ #

    def _kickstart_path(self) -> str:
        return os.path.join(self.cfg.runtime.checkpoint_dir, "kickstart.json")

    def _kickstart_rounds_done(self, restored: bool) -> int:
        path = self._kickstart_path()
        if not restored:
            # A fresh start's weights need the whole kickstart: a sidecar left
            # by an earlier run in a reused checkpoint_dir must not skip it.
            if self.rank == 0 and os.path.exists(path):
                os.remove(path)
            return 0
        if os.path.exists(path):
            with open(path) as f:
                return int(json.load(f)["rounds_done"])
        return self.cfg.train.random_iterations

    def _write_kickstart_progress(self, rounds_done: int):
        if self.rank != 0:
            return
        os.makedirs(self.cfg.runtime.checkpoint_dir, exist_ok=True)
        with open(self._kickstart_path(), "w") as f:
            json.dump({"rounds_done": rounds_done}, f)

    # ------------------------------------------------------------------ #

    def _device_name(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return self.device.type

    def _write_run_meta(self):
        """<log_dir>/run_meta.json: the resolved config, argv, the device, the
        torch version and the git commit; a restart appends an attempt."""
        meta = {
            "config": self.cfg.to_dict(),
            "argv": list(sys.argv),
            "time_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "device": self._device_name(),
            "torch": torch.__version__,
            "processes": distributed.world_size(),
            "git_sha": None,
            "git_dirty": None,
        }
        repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        try:
            sha = subprocess.run(["git", "-C", repo, "rev-parse", "HEAD"],
                                 capture_output=True, text=True, timeout=10)
            if sha.returncode == 0:
                meta["git_sha"] = sha.stdout.strip()
                meta["git_dirty"] = bool(subprocess.run(
                    ["git", "-C", repo, "status", "--porcelain"],
                    capture_output=True, text=True, timeout=10).stdout.strip())
        except (OSError, subprocess.SubprocessError):
            pass
        os.makedirs(self.metrics.log_dir, exist_ok=True)
        path = os.path.join(self.metrics.log_dir, "run_meta.json")
        if os.path.exists(path):
            # Keep the record of the attempts that produced earlier iterations.
            try:
                with open(path) as f:
                    prev = json.load(f)
                meta = {**prev, "attempts": prev.get("attempts", []) + [{
                    k: meta[k] for k in ("argv", "time_utc", "git_sha", "git_dirty")}]}
            except (OSError, ValueError):
                pass
        with open(path, "w") as f:
            json.dump(meta, f, indent=1, default=str)

    def _touch_heartbeat(self):
        """Touch <log_dir>/heartbeat from the main loop: a hang on the device
        blocks it, so a stale mtime is a hang signal for a supervisor."""
        path = os.path.join(self.cfg.runtime.log_dir, "heartbeat")
        try:
            os.makedirs(self.cfg.runtime.log_dir, exist_ok=True)
            with open(path, "a"):
                os.utime(path, None)
        except OSError:
            pass

    def _maybe_update_nu(self, log):
        """Live entropy dose (runtime.traced_nu): when <log_dir>/nu_override
        exists and its mtime changed, read a float from it and use it from
        the next iteration on.  Unparseable content is ignored."""
        path = os.path.join(self.cfg.runtime.log_dir, "nu_override")
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            return
        if mtime == self._nu_mtime:
            return
        self._nu_mtime = mtime
        try:
            with open(path) as f:
                val = float(f.read().strip())
        except (OSError, ValueError):
            return
        if val != self._nu:
            log(f"nu_override: entropy coefficient {self._nu:g} -> {val:g}")
            self._nu = val

    # ------------------------------------------------------------------ #
    # Rollout
    # ------------------------------------------------------------------ #

    def _dev(self, x: np.ndarray) -> torch.Tensor:
        """A host array on the learner's device."""
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _act(self, x: np.ndarray) -> torch.Tensor:
        """A host array on the policy's device."""
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.policy.device)

    def _gumbel(self, n: int) -> torch.Tensor:
        c = self.cfg.wm
        return sample_gumbel((n, c.latent_rows, c.latent_classes), self.rollout_rng,
                             self.policy.device)

    def _eps(self, n: int) -> torch.Tensor:
        return torch.randn(n, self.cfg.env.action_dim, generator=self.rollout_rng,
                           device=self.policy.device)

    def _learner_weights(self) -> List[torch.Tensor]:
        """What the policy reads of the learner: every world-model parameter,
        then the actor's (JAX's ``(wm.params, actor_params)``)."""
        return [*self.state.wm.nets.parameters(), *self.state.ac.actor.parameters()]

    def _refresh_actor(self) -> None:
        """The host-local actor's weight broadcast (JAX's ``_policy_params``):
        when the learner's weights have changed since the last one (their
        storage or in-place version stamps, which an update, a load or a
        move changes), copy them into the actor's.  A CPU learner's are
        copied as they are, in float32; a card's go through the wire at
        ``runtime.broadcast_dtype`` (``broadcast``).  Called before each
        round and each eval, never inside one."""
        if not self.host_actor:
            return
        learner = self._learner_weights()
        stamp = tuple((p.data_ptr(), p._version) for p in learner)
        if stamp == self._actor_stamp:
            return
        actor = [*self.policy.rssm.nets.parameters(), *self.policy.actor.parameters()]
        if self.device.type == "cpu":
            # Not .to("cpu"), which would alias the learner's tensors, which
            # the next update rewrites in place (JAX copies, dreamer.py:337-345).
            with torch.no_grad():
                for dst, src in zip(actor, learner, strict=True):
                    dst.copy_(src)
        else:
            wire = getattr(torch, self.cfg.runtime.broadcast_dtype)
            broadcast.unflatten(broadcast.flatten(learner, wire), actor)
        self._actor_stamp = stamp

    @staticmethod
    def _host_action(action) -> np.ndarray:
        if isinstance(action, torch.Tensor):
            return action.float().cpu().numpy()
        return np.asarray(action, np.float32)

    def rollout_policy(self, random_policy: bool = False) -> Dict[str, float]:
        """Collect sequence_length transitions per env into the replay ring."""
        self._touch_heartbeat()
        self._refresh_actor()
        chunks, metrics = self._collect_chunk(random_policy)
        self._write_chunk(chunks)
        return metrics

    def _collect_chunk(self, random_policy: bool):
        """Step the env farm for one round; returns the host-side chunk.
        Touches the farm, the policy and the rollout stream only, never the
        ring or the learner: with the host-local actor it makes no CUDA call,
        so it may run on a thread beside the learner."""
        p, n = self.policy, self.farm.num_envs
        if self._obs is None:
            self._obs = self.farm.reset_all()
            self._first = np.ones(n, bool)
            self._h, self._z = p.policy_reset(self._act(self._obs), self._gumbel(n))
            self._action = (np.asarray(self.farm.sample_actions(), np.float32)
                            if random_policy else
                            p.policy_act(self._h, self._z, self._eps(n)))

        obs_chunk, act_chunk, rew_chunk, cont_chunk, first_chunk = [], [], [], [], []
        for _ in range(self.cfg.train.sequence_length):
            action_np = self._host_action(self._action)
            obs_next, reward, done, first_next = self.farm.step(action_np)
            obs_chunk.append(self._obs)
            act_chunk.append(action_np)
            rew_chunk.append(reward)
            cont_chunk.append(1.0 - done.astype(np.float32))
            first_chunk.append(self._first.astype(np.float32))
            # The posterior update from the action actually applied (rows whose
            # new frame is a reset frame re-encoded from h = 0), then the next
            # action; a random policy replaces that action.
            self._h, self._z, next_action = p.policy_act_observe(
                self._h, self._z, self._act(action_np), self._act(obs_next),
                self._act(first_next), p.sample_noise(n, self.rollout_rng))
            self._action = (np.asarray(self.farm.sample_actions(), np.float32)
                            if random_policy else next_action)
            self._obs = obs_next
            self._first = first_next

        chunks = (np.stack(obs_chunk, axis=1), np.stack(act_chunk, axis=1),
                  np.stack(rew_chunk, axis=1), np.stack(cont_chunk, axis=1),
                  (np.stack(first_chunk, axis=1) if self.cfg.env.next_step_autoreset
                   else None))
        metrics = {"rollout/reward_mean": float(np.mean(rew_chunk)),
                   "rollout/done_frac": float(1.0 - np.mean(cont_chunk))}
        return chunks, metrics

    def _write_chunk(self, chunks):
        """One ring write per round: the (E, T, ...) chunk."""
        obs, act, rew, cont, first = chunks
        self.buf = self.trainer.buffer.add_batch(
            self.buf, self._dev(obs), self._dev(act.astype(np.float32)),
            self._dev(rew.astype(np.float32)), self._dev(cont.astype(np.float32)),
            first=None if first is None else self._dev(first.astype(np.float32)))

    # ------------------------------------------------------------------ #
    # Evaluation and run
    # ------------------------------------------------------------------ #

    def evaluate_agent(self, eval_episodes: int, max_steps: int = 2000,
                       batched: bool = True) -> float:
        """Mean total reward of deterministic-policy episodes on fresh eval
        envs; by default all episodes run batched, one policy call a step
        for every live episode."""
        if not batched:
            totals = []
            for _ in range(eval_episodes):
                self._eval_seed += 1
                totals.append(self._run_episode(self.eval_env, self._eval_seed, max_steps))
            return float(np.mean(totals))
        return self._evaluate_batched(eval_episodes, max_steps)

    def _evaluate_batched(self, eval_episodes: int, max_steps: int) -> float:
        self._refresh_actor()
        p = self.policy
        if self._eval_farm is None or self._eval_farm.num_envs != eval_episodes:
            if self._eval_farm is not None:
                self._eval_farm.close()
            self._eval_farm = EnvFarm([self._env_factory] * eval_episodes,
                                      seed=self._eval_seed)
        farm = self._eval_farm
        farm.seed = self._eval_seed
        obs = farm.reset_all()
        self._eval_seed += eval_episodes
        h, z = p.policy_reset(self._act(obs), self._gumbel(eval_episodes))
        totals = np.zeros(eval_episodes)
        alive = np.ones(eval_episodes, bool)
        # Device rows <-> episodes: as episodes end, the live rows are
        # compacted into power-of-two buckets (-1 rows are padding).
        rows_ep = np.arange(eval_episodes)
        for _ in range(max_steps):
            action = p.policy_act(h, z, deterministic=True)
            action_np = self._host_action(action)
            obs_rows = np.empty((len(rows_ep),) + obs.shape[1:], np.uint8)
            for r, ep in enumerate(rows_ep):
                if ep < 0 or not alive[ep]:
                    obs_rows[r] = obs[r]
                    continue
                # The envs are stepped directly: an eval episode must not
                # auto-reset, and the next eval's reset_all() resynchronises
                # the farm.
                o, rwd, term, trunc, _ = farm.envs[ep].step(action_np[r])
                totals[ep] += rwd
                if term or trunc:
                    alive[ep] = False
                obs_rows[r] = np.asarray(o, np.uint8)
            if not alive.any():
                break
            obs = obs_rows
            z, h = p.policy_observe(z, h, action, self._act(obs), self._gumbel(len(rows_ep)))
            n_alive = int(alive.sum())
            bucket = 1 << max(0, n_alive - 1).bit_length()
            if bucket < len(rows_ep):
                keep = [r for r, ep in enumerate(rows_ep) if ep >= 0 and alive[ep]]
                sel = np.asarray(keep + [keep[0]] * (bucket - len(keep)))
                idx = self._act(sel)
                h, z = h[idx], z[idx]
                obs = obs[sel]
                rows_ep = np.concatenate([rows_ep[keep], np.full(bucket - len(keep), -1)])
        return float(np.mean(totals))

    def _run_episode(self, env, seed: int, max_steps: int, render: bool = False,
                     frames: Optional[List] = None) -> float:
        self._refresh_actor()
        p = self.policy
        obs, _ = env.reset(seed=seed)
        h, z = p.policy_reset(self._act(np.asarray(obs, np.uint8)[None]), self._gumbel(1))
        total = 0.0
        for _ in range(max_steps):
            if render or frames is not None:
                frame = env.render()
                if frames is not None and frame is not None:
                    frames.append(np.asarray(frame))
            action = p.policy_act(h, z, deterministic=True)
            obs_next, reward, term, trunc, _ = env.step(self._host_action(action)[0])
            total += float(reward)
            if term or trunc:
                break
            z, h = p.policy_observe(z, h, action,
                                    self._act(np.asarray(obs_next, np.uint8)[None]),
                                    self._gumbel(1))
        return total

    def run(self, env=None, env_seed: int = 0, render: bool = True,
            max_steps: int = 10_000, frames: Optional[List] = None) -> float:
        """One episode with the deterministic policy; pass ``frames=[]`` to
        collect the rendered frames."""
        return self._run_episode(env or self.eval_env, env_seed, max_steps, render=render,
                                 frames=frames)

    # ------------------------------------------------------------------ #
    # Checkpoints: full resume
    # ------------------------------------------------------------------ #

    def _checkpoint_tree(self):
        s = self.state
        tree = {
            "state": {
                "wm": s.wm.nets.state_dict(), "wm_opt": _adam_tree(s.wm.opt),
                "actor": s.ac.actor.state_dict(), "critic": s.ac.critic.state_dict(),
                "target_critic": s.ac.target_critic.state_dict(),
                "actor_opt": _adam_tree(s.ac.actor_opt),
                "critic_opt": _adam_tree(s.ac.critic_opt),
                "s_scale": s.ac.s_scale, "step": s.step,
            },
            "rng": self.rng.get_state(),
            "rollout_rng": self.rollout_rng.get_state(),
            "iteration": self.iteration,
            "env_seed": self.farm.seed - self._rank_offset,
            "eval_seed": self._eval_seed,
        }
        if self.cfg.runtime.checkpoint_replay:
            b = self.buf
            tree["buffer"] = {"obs": b.obs, "action": b.action, "reward": b.reward,
                              "cont": b.cont, "first": b.first, "next_idx": b.next_idx,
                              "size": b.size}
        return tree

    def save_checkpoint(self):
        tree = self._checkpoint_tree()
        if self.plan is None:
            return self.ckpt.save(self.iteration, tree)
        # The state (alike on every rank, written by rank 0) and this rank's
        # shard: its ring and its rollout stream.
        shard = {k: tree.pop(k) for k in ("rollout_rng", "buffer") if k in tree}
        tree["world_size"] = self.plan.world_size
        return self.ckpt.save(self.iteration, tree, shard=shard)

    def _maybe_save_best(self, reward: float):
        """Export the weights and best.json whenever eval improves (outside
        the pruned ckpt_* set, so the best policy always survives)."""
        if reward <= self.best_eval:
            return
        self.best_eval = reward
        if self.rank != 0:
            return
        base = self.cfg.runtime.checkpoint_dir
        os.makedirs(base, exist_ok=True)
        self.save_agent(os.path.join(base, "agent_best"))
        with open(os.path.join(base, "best.json"), "w") as f:
            json.dump({"iteration": self.iteration, "eval_reward": reward}, f)

    def _agent_tree(self):
        ac = self.state.ac
        return {"wm": self.state.wm.nets.state_dict(), "actor": ac.actor.state_dict(),
                "critic": ac.critic.state_dict(),
                "target_critic": ac.target_critic.state_dict()}

    def save_agent(self, path: str):
        """Weights-only export: every module's parameters, no optimizer or
        replay state."""
        atomic_save(self._agent_tree(), path)

    def _load_modules(self, tree) -> None:
        ac = self.state.ac
        for module, key in ((self.state.wm.nets, "wm"), (ac.actor, "actor"),
                            (ac.critic, "critic"), (ac.target_critic, "target_critic")):
            module.load_state_dict(tree[key])
        self.state.wm.nets.prepare_kernels()

    def load_agent(self, path: str):
        """Weights-only import of a ``save_agent`` export, onto this run's
        device."""
        self._load_modules(load(path))

    def _load_state(self, saved) -> None:
        s = self.state
        with torch.no_grad():
            self._load_modules(saved)
            for opt, key in ((s.wm.opt, "wm_opt"), (s.ac.actor_opt, "actor_opt"),
                             (s.ac.critic_opt, "critic_opt")):
                _load_adam(opt, saved[key], key)
            _copy_into(s.ac.s_scale, saved["s_scale"], "s_scale")
            _copy_into(s.step, saved["step"], "step")

    def _load_ring(self, saved) -> None:
        b = self.buf
        if (saved["first"] is None) != (b.first is None):
            raise ValueError("checkpoint: the ring's episode-start channel does not match "
                             "env.next_step_autoreset")
        with torch.no_grad():
            for name in ("obs", "action", "reward", "cont", "first"):
                if saved[name] is not None:
                    _copy_into(getattr(b, name), saved[name], f"buffer.{name}")
        b.next_idx, b.size = int(saved["next_idx"]), int(saved["size"])

    def restore_latest(self) -> bool:
        """Resume from the newest checkpoint; returns True if one was found.
        A ring in the checkpoint is restored whatever runtime.checkpoint_replay
        now says; without one the ring stays fresh and train() re-primes it."""
        result = self.ckpt.restore_latest()
        if result is None:
            return False
        _, tree = result
        self._restore_generators(tree)
        self._load_state(tree["state"])
        self._ring_restored = "buffer" in tree
        if self._ring_restored:
            self._load_ring(tree["buffer"])
        self.iteration = int(tree["iteration"])
        self.farm.seed = int(tree["env_seed"]) + self._rank_offset
        self._eval_seed = int(tree["eval_seed"])
        # The recurrent rollout state is not checkpointed: the next round
        # starts new episodes.
        self._obs = None
        # A resumed run never overwrites agent_best with a worse policy.
        best_path = os.path.join(self.cfg.runtime.checkpoint_dir, "best.json")
        if os.path.exists(best_path):
            with open(best_path) as f:
                self.best_eval = float(json.load(f)["eval_reward"])
        return True

    def _restore_generators(self, tree) -> None:
        """Continue both saved streams; when one comes from another device
        type than this run's stream (a CPU generator's state is 5,056 bytes,
        a CUDA one's 16, and neither takes the other's), reseed both from
        ``train.seed`` and the restored iteration instead, as JAX's host-side
        keys would resume on any platform."""
        gens = (self.rng, self.rollout_rng)
        saved = (tree["rng"], tree["rollout_rng"])
        crossed = [(s, g) for s, g in zip(saved, gens) if s.numel() != g.get_state().numel()]
        if not crossed:
            for g, s in zip(gens, saved):
                g.set_state(s)
            return
        iteration = int(tree["iteration"])
        base = self.cfg.train.seed + RESEED_STRIDE * (iteration + 1)
        self.rng.manual_seed(base)
        self.rollout_rng.manual_seed(base + 1 + self._rank_offset)
        state, gen = crossed[0]
        other = "cuda" if gen.device.type == "cpu" else "cpu"
        print(f"resume: the checkpoint's generators are from a {other} device "
              f"({state.numel()}-byte state), this run is on {gen.device}: both streams "
              f"reseeded from train.seed {self.cfg.train.seed} and iteration {iteration} "
              f"({base}, {base + 1})", flush=True)

    def request_stop(self):
        """Ask the train loop to checkpoint and return after the current
        iteration or kickstart round (signal-safe: only sets a flag).  Under a
        mesh rank 0's flag decides for every rank."""
        self._stop_requested = True

    def _should_stop(self) -> bool:
        """Rank 0's stop flag, on every rank (the checkpoint is collective)."""
        if self.plan is None:
            return self._stop_requested
        return bool(self.plan.broadcast(float(self.rank == 0 and self._stop_requested)))

    def _eval_and_sync(self, episodes: int) -> float:
        """An eval on rank 0 only, its mean reward on every rank (they take
        the same best-checkpoint decisions).  The other ranks advance their
        eval seed as the eval does, so every rank checkpoints the same."""
        if self.plan is None or self.plan.world_size == 1:
            return self.evaluate_agent(episodes)
        if self.rank == 0:
            reward = self.evaluate_agent(episodes)
        else:
            reward = 0.0
            self._eval_seed += episodes
        return self.plan.broadcast(reward)

    def _stop_and_checkpoint(self, log, message: str) -> float:
        log(message)
        self.save_checkpoint()
        self.ckpt.wait_until_finished()
        self.metrics.save_npz()
        self.stopped = True
        return self.best_eval

    @contextlib.contextmanager
    def _at_iteration(self, iteration: int):
        """Name the iteration in a ``runtime.debug_nans`` error raised inside."""
        try:
            yield
        except FloatingPointError as e:
            raise FloatingPointError(f"{e}, at iteration {iteration}") from e

    # ------------------------------------------------------------------ #
    # Master loop
    # ------------------------------------------------------------------ #

    def train(self, resume: bool = False, progress: bool = True) -> float:
        cfg = self.cfg.train
        self.stopped = False
        restored = False
        self._touch_heartbeat()
        if resume:
            restored = self.restore_latest()
            self._touch_heartbeat()

        log = print if progress else (lambda *a, **k: None)
        log("Starting Training...")
        rounds_done = self._kickstart_rounds_done(restored)
        kickstart_pending = self.iteration == 0 and rounds_done < cfg.random_iterations
        if restored:
            prime_rounds = cfg.resume_prime_iterations
            if prime_rounds == 0 and not self._ring_restored and not kickstart_pending:
                # A ring-less resume would train on a ring primed only to one
                # window: default the re-prime to the kickstart's budget.
                prime_rounds = cfg.random_iterations
                log(f"WARNING: checkpoint carried no replay ring and "
                    f"train.resume_prime_iterations=0; defaulting re-prime "
                    f"to random_iterations={prime_rounds} rounds.")
            if prime_rounds > 0:
                # buf.size counts per-env ring positions: a round adds
                # sequence_length of them.
                target = min(prime_rounds * cfg.sequence_length, self.trainer.buffer.capacity)
                if self.buf.size < target:
                    log(f"Re-priming replay ring to {target} transitions "
                        "with random rollouts...")
                    while self.buf.size < target:
                        self.rollout_policy(random_policy=True)
                    log("Re-priming done.")
        if kickstart_pending:
            log(f"Starting Random Kickstart ({rounds_done}/{cfg.random_iterations} "
                "rounds done).")
            for r in range(rounds_done, cfg.random_iterations):
                if self._should_stop():
                    self._write_kickstart_progress(r)
                    return self._stop_and_checkpoint(
                        log, "Stop requested during kickstart; checkpointing and exiting "
                        "cleanly.")
                with self._at_iteration(0):
                    self.rollout_policy(random_policy=True)
                    if self.buf.size >= cfg.sequence_length:
                        self.state, _ = self.trainer.wm_step(self.state, self.buf, self.rng)
            log("Kickstart done.")
            self._write_kickstart_progress(cfg.random_iterations)
            reward = self._eval_and_sync(cfg.eval_episodes)
            self.metrics.log_eval(0, reward)
            self._maybe_save_best(reward)
            log(f"Initial eval reward: {reward:.2f}")
            # A crash before the first periodic checkpoint must not redo the
            # kickstart.
            self.save_checkpoint()
            self.metrics.save_npz()

        # Never learn from unwritten ring slots.
        while self.buf.size < cfg.sequence_length:
            self.rollout_policy(random_policy=True)

        # The overlapped rollout's one thread (runtime.async_rollout).
        executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="rollout") \
            if self.cfg.runtime.async_rollout else None
        profiler = None
        try:
            while self.iteration < cfg.training_iterations:
                self._touch_heartbeat()
                # Optional torch.profiler window over iterations 5..10.
                if self.cfg.runtime.profile and self.iteration == 5 and profiler is None:
                    profiler = self._start_profile()
                if profiler is not None and self.iteration >= 10:
                    self._stop_profile(profiler)
                    profiler = None

                nu = None
                t_iter = time.perf_counter()
                phase_s: Dict[str, float] = {}
                if self.cfg.runtime.traced_nu:
                    self._maybe_update_nu(log)
                    nu = torch.tensor(self._nu, dtype=torch.float32, device=self.device)
                    phase_s["ac/nu"] = self._nu
                with self._at_iteration(self.iteration + 1):
                    if executor is not None:
                        # The next round is collected on the thread with the
                        # weights of before this update, while the learner
                        # trains on the ring without it; then it is written.
                        # A raise in the thread surfaces from result(); one in
                        # the learner waits for the thread at the shutdown.
                        self._refresh_actor()
                        future = executor.submit(self._collect_chunk, False)
                        self.state, step_metrics = self.trainer.train_iteration(
                            self.state, self.buf, self.rng, nu)
                        chunks, roll_metrics = future.result()
                        self._write_chunk(chunks)
                    else:
                        roll_metrics = self.rollout_policy(random_policy=False)
                        phase_s["perf/rollout_s"] = time.perf_counter() - t_iter
                        t_learn = time.perf_counter()
                        self.state, step_metrics = self.trainer.train_iteration(
                            self.state, self.buf, self.rng, nu)
                    step_metrics = metrics_to_host(step_metrics)
                self.iteration += 1
                # The host read above waits for the learner, so the phase
                # times cover its work; overlapped, only the whole
                # iteration's rates mean anything.
                dt = time.perf_counter() - t_iter
                if executor is None:
                    phase_s["perf/learner_s"] = time.perf_counter() - t_learn
                # One update = one optimizer step: a WM epoch steps one
                # optimizer, an AC epoch two.
                n_updates = cfg.wm_epochs + 2 * cfg.ac_epochs
                n_steps = cfg.sequence_length * self.n_envs_global
                phase_s["perf/env_steps_per_s"] = n_steps / dt
                phase_s["perf/grad_updates_per_s"] = n_updates / dt
                self.metrics.log_iteration(self.iteration,
                                           {**roll_metrics, **step_metrics, **phase_s})

                if self._should_stop():
                    return self._stop_and_checkpoint(
                        log, f"Stop requested; checkpointing at iter {self.iteration} and "
                        "exiting cleanly.")
                if self.iteration % cfg.checkpoint_every == 0:
                    self.save_checkpoint()
                    self.metrics.save_npz()
                if self.iteration % cfg.eval_every == 0:
                    reward = self._eval_and_sync(cfg.eval_episodes)
                    self.metrics.log_eval(self.iteration, reward)
                    self._maybe_save_best(reward)
                    ent = step_metrics.get("ac/entropy")
                    ent_s = f", entropy {float(ent):.2f}" if ent is not None else ""
                    log(f"iter {self.iteration}: eval reward {reward:.2f}, "
                        f"wm loss {float(step_metrics['wm/loss']):.3f}{ent_s}")
        finally:
            if executor is not None:
                executor.shutdown(wait=True)
            if profiler is not None:
                self._stop_profile(profiler)

        log("Training Complete.")
        reward = self._eval_and_sync(cfg.final_eval_episodes)
        self.metrics.log_eval(self.iteration, reward)
        self._maybe_save_best(reward)
        self.save_checkpoint()
        self.ckpt.wait_until_finished()
        self.metrics.save_npz()
        return reward

    def _start_profile(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.__enter__()
        return profiler

    def _stop_profile(self, profiler) -> None:
        profiler.__exit__(None, None, None)
        out = os.path.join(self.cfg.runtime.log_dir, "profile")
        os.makedirs(out, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(out, f"trace_{self.iteration}.json"))
