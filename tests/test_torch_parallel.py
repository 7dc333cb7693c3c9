"""The data axis of ``runtime.mesh_shape`` (``dreamer_tpu_torch.parallel``)
against one process and against JAX's shard-aware replay draw.

- ``ReplayBuffer.draw_indices(n_shards=1)`` draws today's stream bit for
  bit; with shards every row's env lies in its shard's block
  (``dreamer_tpu/replay/buffer.py:166-200``), and a shard's ring gives the
  global gather's rows (``sample_shard_local``, ``:232-272``); the port's
  gather equals JAX's ``_gather`` from the same indices.
- Two ranks over gloo on the CPU (one spawn of ``run`` below):
  one ``train_iteration`` equals one process's ``n_shards=2`` iteration in
  float32, parameters to 1e-5; so do crafted cases where free bits fall
  between the ranks' KL means and where the ranks' return quantiles differ
  from the global ones, and a NaN in one rank's rows skips the update on
  both.  Each case also runs with its collective left out (a plan without
  it), and then fails.
- ``make_mesh`` and its model axis, ``init_distributed``'s no-op and
  its refusal of NCCL on a shared card, the metrics logger of a rank that
  does not write, and the checkpoint's world-size refusal.
- One rank's ``Dreamer`` (torchrun's variables set, no process group, so
  the collectives are the identity): its block of the farm and the ring,
  its env seeds, rank 0's writes and eval left to rank 0, its checkpoint
  shard; and the splits a run refuses.
"""

import datetime
import multiprocessing
import os
import socket
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.orchestrator import Dreamer
from dreamer_tpu_torch.parallel import MeshPlan, distributed, make_mesh
from dreamer_tpu_torch.replay.buffer import ReplayBuffer
from dreamer_tpu_torch.train.step import Trainer
from dreamer_tpu_torch.utils import CheckpointManager, MetricsLogger

T, E, A, OBS = 8, 4, 3, (6, 6)
PARAM_ATOL = 1e-5
SPAWN_TIMEOUT_S = 120


# ---------------------------------------------------------------------- #
# The ranks' side (spawned ranks import this module: JAX is imported only
# inside the test that compares with it, so a rank starts fast).  Each case
# builds a Trainer with a MeshPlan (or a plan with one collective left out),
# fills this rank's env block of a ring made from a numpy seed, runs one
# train_iteration from a generator seeded alike on every rank, and saves
# what the parent compares; the parent computes the one-process n_shards=2
# references with ``reference``.
# ---------------------------------------------------------------------- #

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "fake_smoke.yaml")
# The global batch of 8 rows and 4 envs: 4 rows and 2 envs a rank.
BASE = ("env.num_envs=4", "train.batch_size=8", "train.buffer_size=1024")
STEPS = 48          # ring steps an env: three windows of 16
GEN_SEED = 7        # the learner generator's seed, alike on every rank
CRITIC_SCALE = 3.0  # the target critic's output layer, for returns whose range exceeds 1


class NoGradMean(MeshPlan):
    """Reduces the non-finite flag but leaves every rank its own gradients."""

    def reduce_update(self, grads, finite):
        _, finite = super().reduce_update([torch.zeros(1)], finite)
        return list(grads), finite


class NoFlag(MeshPlan):
    """Averages the gradients but lets each rank decide the skip alone."""

    def reduce_update(self, grads, finite):
        grads, _ = super().reduce_update(grads, finite)
        return grads, finite


class NoStats(MeshPlan):
    """The world-model loss's batch statistics stay this rank's."""

    def sum(self, x):
        return x.detach().clone()


class NoGather(MeshPlan):
    """The return scale from this rank's returns alone."""

    def gather(self, x):
        return x


PLANS = {"full": MeshPlan, "no_grad_mean": NoGradMean, "no_flag": NoFlag,
         "no_stats": NoStats, "no_gather": NoGather}


def config(overrides=()) -> DreamerConfig:
    return DreamerConfig.from_yaml(SMOKE, overrides=[*BASE, *overrides])


def ring_data(cfg: DreamerConfig, nan_envs=()):
    """(obs, action, reward, cont) of every env, ``STEPS`` steps, from a
    numpy seed; a few episode ends, so the ranks' masks differ.  The actions
    of ``nan_envs`` are NaN."""
    rng = np.random.default_rng(3)
    E, (h, w), A = cfg.env.num_envs, cfg.wm.obs_size, cfg.env.action_dim
    obs = rng.integers(0, 256, (E, STEPS, h, w, 3), dtype=np.uint8)
    action = rng.uniform(-1, 1, (E, STEPS, A)).astype(np.float32)
    reward = rng.normal(0, 1, (E, STEPS)).astype(np.float32)
    cont = (rng.uniform(size=(E, STEPS)) > 0.1).astype(np.float32)
    action[list(nan_envs)] = np.nan
    return obs, action, reward, cont


def build(cfg: DreamerConfig, plan=None, n_shards: int = 1, nan_envs=(), critic=False):
    """A trainer, its state and its ring (this rank's env block under a plan)."""
    trainer = Trainer(cfg, device="cpu", seed=cfg.train.seed, plan=plan, n_shards=n_shards)
    state = trainer.init_state()
    if critic:
        with torch.no_grad():
            for p in state.ac.target_critic.denses[-1].parameters():
                p.mul_(CRITIC_SCALE)
    data = ring_data(cfg, nan_envs)
    block = slice(None) if plan is None else plan.env_block(cfg.env.num_envs)
    ring = trainer.buffer.add_batch(trainer.init_ring(),
                                    *(torch.from_numpy(np.ascontiguousarray(d[block]))
                                      for d in data))
    return trainer, state, ring


def snapshot(state, metrics):
    params = {}
    for name, module in (("wm", state.wm.nets), ("actor", state.ac.actor),
                         ("critic", state.ac.critic), ("target", state.ac.target_critic)):
        for k, v in module.state_dict().items():
            params[f"{name}.{k}"] = v.detach().clone()
    return {"params": params, "s_scale": state.ac.s_scale.clone(),
            "metrics": {k: v.detach().clone() for k, v in metrics.items()}}


def iterate(case, plan=None, n_shards=1):
    """One train_iteration of ``case`` = (overrides, nan_envs, critic)."""
    overrides, nan_envs, critic = case
    trainer, state, ring = build(config(overrides), plan, n_shards, nan_envs, critic)
    state, metrics = trainer.train_iteration(state, ring, torch.Generator().manual_seed(GEN_SEED))
    return snapshot(state, metrics)


def reference(case):
    """The one-process update of the whole batch drawn as two shards."""
    return iterate(case, n_shards=2)


def first_batch_kl(overrides=()):
    """The mean dynamics KL of each shard's rows in the first world-model
    batch, before any update: where free bits can fall between them."""
    from dreamer_tpu_torch.train.world_model import wm_loss

    cfg = config(overrides)
    trainer, _, ring = build(cfg, n_shards=2)
    gen = torch.Generator().manual_seed(GEN_SEED)
    batch = trainer._sample(ring, gen, t_out=cfg.train.horizon)
    gumbel = trainer.sample_wm_noise(cfg.train.batch_size, gen)
    half = cfg.train.batch_size // 2
    out = []
    with torch.no_grad():
        for rows in (slice(0, half), slice(half, None)):
            _, m = wm_loss(trainer.rssm, *(b[rows] for b in batch[:4]),
                           gumbel[:, rows].contiguous(), cfg)
            out.append(float(m["wm/kl_dyn"]))
    return out


def run(rank: int, world: int, port: int, out_dir: str, cases: dict) -> None:
    """Join a gloo group of ``world`` ranks on localhost:``port``, run every
    case (name -> (plan name, case)) and save the results."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)   # tiny widths; the ranks share the test host's cores
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        results = {}
        for name, (plan_name, case) in cases.items():
            plan = PLANS[plan_name](make_mesh(world, 1), "cpu")
            results[name] = iterate(case, plan)
            results[name]["calls"] = plan.calls
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()




def ring(capacity=64 * E, steps=40, seed=0, store_firsts=False):
    """A port ring of E envs with ``steps`` written, and the numpy chunk."""
    rng = np.random.default_rng(seed)
    buf = ReplayBuffer(capacity, T, A, OBS, num_envs=E, store_firsts=store_firsts)
    chunk = (rng.integers(0, 256, (E, steps, *OBS, 3), dtype=np.uint8),
             rng.uniform(-1, 1, (E, steps, A)).astype(np.float32),
             rng.normal(size=(E, steps)).astype(np.float32),
             (rng.uniform(size=(E, steps)) > 0.2).astype(np.float32))
    return buf, buf.add_batch(buf.init_state(), *map(torch.from_numpy, chunk)), chunk


# ---------------------------------------------------------------------- #
# The shard-aware draw
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("steps", [40, 200], ids=["filling", "wrapped"])
def test_unsharded_draw_is_todays_stream(steps):
    buf, st, _ = ring(steps=steps)
    got = buf.draw_indices(st, 32, torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    hi = buf.valid_starts(st)
    draws = (torch.randint(0, E, (32,), generator=g), torch.randint(0, hi, (32,), generator=g),
             torch.randint(0, hi, (32,), generator=g))
    want = buf.pick_indices(st, *draws)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(got[0], buf.draw_indices(st, 32, torch.Generator().manual_seed(5),
                                                n_shards=1)[0])


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_rows_draw_in_their_block(n_shards):
    buf, st, _ = ring(steps=200)
    B = 16
    env_idx, starts = buf.draw_indices(st, B, torch.Generator().manual_seed(1), n_shards)
    shard = torch.arange(B) // (B // n_shards)
    lo = shard * (E // n_shards)
    assert bool(((env_idx >= lo) & (env_idx < lo + E // n_shards)).all())
    assert bool(((starts >= 0) & (starts < buf.valid_starts(st))).all())
    with pytest.raises(ValueError, match="divide"):
        buf.draw_indices(st, 6, torch.Generator(), 4)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_a_shards_ring_gives_the_global_rows(n_shards):
    buf, st, chunk = ring(steps=200, seed=2)
    B = 16
    whole = buf.sample(st, B, torch.Generator().manual_seed(3), t_out=5, n_shards=n_shards)
    per, e_local = B // n_shards, E // n_shards
    for s in range(n_shards):
        block = slice(s * e_local, (s + 1) * e_local)
        mine = buf.add_batch(buf.init_state(n_shards=n_shards),
                             *(torch.from_numpy(np.ascontiguousarray(c[block])) for c in chunk))
        assert mine.obs.shape[0] == e_local
        got = buf.sample(mine, B, torch.Generator().manual_seed(3), t_out=5,
                         n_shards=n_shards, shard=s)
        for a, b in zip(got, whole):
            assert torch.equal(a, b[s * per:(s + 1) * per])


@pytest.mark.parametrize("n_shards", [1, 2])
def test_gather_equals_jax_from_the_same_indices(n_shards):
    import jax
    import jax.numpy as jnp

    from dreamer_tpu.replay import ReplayBuffer as JaxBuffer

    buf, st, chunk = ring(steps=200, seed=4)
    ref = JaxBuffer(64 * E, T, A, OBS, num_envs=E)
    rs = ref.add_batch(ref.init_state(), *map(jnp.asarray, chunk))
    # The stored symlog rewards may differ by an ulp (XLA's log1p); the
    # gather is held on equal rings.
    st.reward.copy_(torch.from_numpy(np.array(rs.reward)))
    env_idx, starts = ref._draw_indices(rs, jax.random.PRNGKey(9), 16, n_shards)
    want = ref._gather(rs, env_idx, starts, 5, True)
    got = buf.gather(st, torch.from_numpy(np.array(env_idx)).long(),
                     torch.from_numpy(np.array(starts)).long(), 5)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------- #
# Two ranks over gloo against one process
# ---------------------------------------------------------------------- #

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every case on two spawned ranks, and each case's one-process
    reference.  A case: (overrides, NaN envs, a wide target critic)."""
    lo, hi = sorted(first_batch_kl())
    free_bits = lo + 0.25 * (hi - lo)   # rank means on either side, the global above
    cases = {"natural": ((), (), False),
             "free_bits": ((f"wm.free_bits={free_bits!r}",), (), False),
             "quantile": ((), (), True),
             "nan": ((), (2, 3), False)}   # envs 2, 3: rank 1's block
    runs = {"natural": ("full", cases["natural"]),
            "no_grad_mean": ("no_grad_mean", cases["natural"]),
            "free_bits": ("full", cases["free_bits"]),
            "free_bits_no_stats": ("no_stats", cases["free_bits"]),
            "quantile": ("full", cases["quantile"]),
            "quantile_no_gather": ("no_gather", cases["quantile"]),
            "nan": ("full", cases["nan"]),
            "nan_no_flag": ("no_flag", cases["nan"])}
    out = tmp_path_factory.mktemp("ranks")
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=run, args=(r, 2, port, str(out), runs), daemon=True)
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(SPAWN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0, 0], "a rank failed (its traceback is above)"
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=True) for r in range(2)]
    refs = {name: reference(case) for name, case in cases.items()}
    return {"ranks": ranks, "refs": refs, "kl": (lo, hi), "free_bits": free_bits}


def param_gap(got, ref) -> float:
    return max(float((got["params"][k] - v).abs().max()) for k, v in ref["params"].items())


def equal_to_reference(two_ranks, run, case):
    ref = two_ranks["refs"][case]
    for r, res in enumerate(two_ranks["ranks"]):
        got = res[run]
        gap = param_gap(got, ref)
        assert gap <= PARAM_ATOL, (run, r, gap)
        torch.testing.assert_close(got["s_scale"], ref["s_scale"], rtol=1e-5, atol=0)
        for k, v in ref["metrics"].items():
            if k != "ac/adv_std":   # a mean of the ranks' standard deviations
                torch.testing.assert_close(got["metrics"][k], v, rtol=1e-4, atol=1e-5, equal_nan=True,
                                           msg=f"{run} rank {r} {k}")


def test_two_ranks_equal_one_process_with_two_shards(two_ranks):
    equal_to_reference(two_ranks, "natural", "natural")
    a, b = (res["natural"] for res in two_ranks["ranks"])
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    # Each update's gradients (one flat all-reduce each) and the WM loss's
    # statistics, the return gather and the two metrics means.
    assert a["calls"] == 6
    # The update moved the weights.
    start = snapshot(build(config(), n_shards=2)[1], {})
    assert param_gap(a, start) > 0


def test_without_the_gradient_mean_the_ranks_part(two_ranks):
    ref = two_ranks["refs"]["natural"]
    gaps = [param_gap(res["no_grad_mean"], ref) for res in two_ranks["ranks"]]
    assert min(gaps) > 10 * PARAM_ATOL, gaps


def test_free_bits_clamp_the_global_kl_mean(two_ranks):
    lo, hi = two_ranks["kl"]
    assert lo < two_ranks["free_bits"] < (lo + hi) / 2 < hi
    equal_to_reference(two_ranks, "free_bits", "free_bits")
    # With each rank's own statistics the rank below free bits drops its KL
    # gradient, and the mask count of the denominator is its own.
    ref = two_ranks["refs"]["free_bits"]
    gaps = [param_gap(res["free_bits_no_stats"], ref) for res in two_ranks["ranks"]]
    assert min(gaps) > 10 * PARAM_ATOL, gaps


def test_the_return_scale_reads_every_ranks_returns(two_ranks):
    ref = two_ranks["refs"]["quantile"]
    assert float(ref["s_scale"]) > 1.0 + 1e-3   # the returns' P95 - P05 exceeds 1
    equal_to_reference(two_ranks, "quantile", "quantile")
    for res in two_ranks["ranks"]:
        got = res["quantile_no_gather"]
        assert abs(float(got["s_scale"]) - float(ref["s_scale"])) > 1e-3 * float(ref["s_scale"])
    a, b = (float(res["quantile_no_gather"]["s_scale"]) for res in two_ranks["ranks"])
    assert a != b


def test_a_nan_on_one_rank_skips_both(two_ranks):
    start = snapshot(build(config(), n_shards=2)[1], {})["params"]
    for res in two_ranks["ranks"]:
        got = res["nan"]
        assert float(got["metrics"]["wm/update_skipped"]) == 1.0
        assert float(got["metrics"]["ac/update_skipped"]) == 1.0
        assert all(torch.equal(got["params"][k], v) for k, v in start.items())
    equal_to_reference(two_ranks, "nan", "nan")
    # Deciding alone, the finite rank writes the NaN-poisoned mean.
    rank0 = two_ranks["ranks"][0]["nan_no_flag"]["params"]
    assert not all(bool(torch.isfinite(v).all()) for v in rank0.values())


def test_each_collective_mutant_changes_one_line_of_its_source():
    """Each faulty copy of a collective that chip_mutants.py builds for the
    card's update check replaces a line found exactly once in its source,
    and the same four are left out by this file's plans."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_mutants",
                                                  os.path.join(ROOT, "chip_mutants.py"))
    mutants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mutants)
    assert set(mutants.DP_MUTANTS) == {"dp_grad_mean", "dp_free_bits", "dp_quantile",
                                       "dp_nan_flag"}
    for source, good, bad, checks in mutants.DP_MUTANTS.values():
        with open(os.path.join(ROOT, "dreamer_tpu_torch", source)) as f:
            assert f.read().count(good) == 1 and bad != good
        assert checks == ("update",) and "update" in mutants.CHECKS


# ---------------------------------------------------------------------- #
# The mesh, the process group, the writers
# ---------------------------------------------------------------------- #

def test_make_mesh_and_the_model_axis(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    mesh = make_mesh(1, 1)
    assert (mesh.n_data, mesh.n_model, mesh.rank, mesh.world_size) == (1, 1, 0, 1)
    with pytest.raises(ValueError, match="needs 2 ranks, the world has 1"):
        make_mesh(2, 1)
    # The model axis: in a world of 2, [1, 2] puts both ranks at data index
    # 0, rank r at model index r; a mesh of another size is refused.
    monkeypatch.setenv("WORLD_SIZE", "2")
    for r in range(2):
        monkeypatch.setenv("RANK", str(r))
        mesh = make_mesh(1, 2)
        assert (mesh.n_data, mesh.n_model, mesh.data_index, mesh.model_index) == (1, 2, 0, r)
    for shape in ((2, 2), (1, 4), (4, 1)):
        with pytest.raises(ValueError, match=f"needs {shape[0] * shape[1]} ranks, the world "
                                             "has 2"):
            make_mesh(*shape)


def test_init_distributed(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.init_distributed() is False
    assert distributed.rank_device() is None and distributed.is_primary()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert distributed.rank_device() == torch.device("cuda", 1)
    assert distributed.hosts() == 1 and not distributed.is_primary()
    # Two ranks on one card: refused before the process group is joined.
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one device"):
        distributed.init_distributed("nccl", "cuda:0")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        distributed.init_distributed("nccl", "cpu")
    assert not torch.distributed.is_initialized()


def test_a_rank_that_does_not_log_writes_nothing(tmp_path):
    m = MetricsLogger(str(tmp_path / "logs"), enabled=False)
    m.log_iteration(1, {"wm/loss": 1.0})
    m.log_eval(1, 2.0)
    assert m.save_npz() is None and m.wm_losses == [[1.0]]
    assert not (tmp_path / "logs").exists()


def test_a_checkpoint_resumes_only_at_its_world_size(tmp_path):
    class Plan:   # one rank of two, as far as the manager can see
        rank, world_size, mesh_shape, group_first = 0, 2, (2, 1), 0

        def barrier(self):
            pass

    sharded = CheckpointManager(str(tmp_path / "a"), plan=Plan())
    sharded.save(4, {"iteration": 4, "world_size": 2}, shard={"buffer": torch.arange(3)})
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == ["LATEST", "ckpt_4",
                                                                   "ckpt_4.rank0"]
    step, tree = sharded.restore_latest()
    assert step == 4 and torch.equal(tree["buffer"], torch.arange(3))
    with pytest.raises(ValueError, match=r"written by 2 ranks as mesh \[2, 1\], this run is "
                                         "one process"):
        CheckpointManager(str(tmp_path / "a")).restore_latest()
    CheckpointManager(str(tmp_path / "b")).save(2, {"iteration": 2})
    with pytest.raises(ValueError, match=r"one process without a mesh, this run is 2 ranks "
                                         r"as mesh \[2, 1\]"):
        CheckpointManager(str(tmp_path / "b"), plan=Plan()).restore_latest()
    # Pruning takes a step's shards with it.
    for step in (5, 6, 7):
        sharded.save(step, {"iteration": step, "world_size": 2}, shard={})
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == [
        "LATEST", "ckpt_5", "ckpt_5.rank0", "ckpt_6", "ckpt_6.rank0", "ckpt_7", "ckpt_7.rank0"]


# ---------------------------------------------------------------------- #
# One rank's share of the run (no process group: the collectives are the
# identity, so a rank's own layout and writes are seen alone)
# ---------------------------------------------------------------------- #

def rank_env(monkeypatch, rank, world, local_world):
    for k, v in (("RANK", rank), ("LOCAL_RANK", rank % local_world), ("WORLD_SIZE", world),
                 ("LOCAL_WORLD_SIZE", local_world)):
        monkeypatch.setenv(k, str(v))


def rank_cfg(tmp_path, *extra):
    return DreamerConfig.from_yaml(SMOKE, overrides=[
        f"runtime.checkpoint_dir={tmp_path}/models", f"runtime.log_dir={tmp_path}/logs",
        "runtime.rollout_device=cpu", "env.num_envs=4", *extra])


@pytest.mark.parametrize("world,local_world,per_rank", [(2, 2, 2), (4, 2, 2)],
                         ids=["one_host", "two_hosts"])
def test_a_rank_steps_its_block_of_the_farm(tmp_path, monkeypatch, world, local_world,
                                             per_rank):
    rank_env(monkeypatch, 1, world, local_world)
    d = Dreamer(rank_cfg(tmp_path, f"runtime.mesh_shape=[{world},1]"), device="cpu")
    try:
        hosts = world // local_world
        assert (d.rank, d.n_envs_global, d.trainer.buffer.num_envs) == (1, 4 * hosts, 4 * hosts)
        assert d.farm.num_envs == per_rank and d.buf.obs.shape[0] == per_rank
        assert d.farm.seed == d.cfg.train.seed + 100_003
        assert d.trainer.rows == slice(8 // world, 2 * 8 // world)
        # Not rank 0: no metrics file, no run_meta.json, no eval of its own.
        assert not d.metrics.enabled and not (tmp_path / "logs" / "run_meta.json").exists()
        d.rollout_policy(random_policy=True)
        assert d.buf.size == d.cfg.train.sequence_length
        seed = d._eval_seed
        assert d._eval_and_sync(3) == 0.0 and d._eval_seed == seed + 3
        assert d._eval_farm is None
        # Its checkpoint is its shard; LATEST is rank 0's to move.
        d.save_checkpoint()
        d.ckpt.wait_until_finished()
        assert sorted(p.name for p in (tmp_path / "models").iterdir()) == ["ckpt_0.rank1"]
    finally:
        d.close()


def test_a_rank_refuses_what_the_run_cannot_split(tmp_path, monkeypatch):
    rank_env(monkeypatch, 0, 2, 2)
    with pytest.raises(ValueError, match="needs runtime.mesh_shape"):
        Dreamer(rank_cfg(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="rollout_device='cpu'"):
        Dreamer(rank_cfg(tmp_path, "runtime.mesh_shape=[2,1]", "runtime.rollout_device=default"),
                device="cpu")
    with pytest.raises(ValueError, match="does not divide into 2 data shards"):
        Dreamer(rank_cfg(tmp_path, "runtime.mesh_shape=[2,1]", "env.num_envs=3"), device="cpu")
    with pytest.raises(ValueError, match="train.batch_size 7 does not divide"):
        Dreamer(rank_cfg(tmp_path, "runtime.mesh_shape=[2,1]", "train.batch_size=7"),
                device="cpu")


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
