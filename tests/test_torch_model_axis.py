"""The model axis of ``runtime.mesh_shape`` (``[n, m]``, m > 1) against
JAX's choice of sharded weights and against one process.

- The port's sharded weights (``parallel.model_blocks``) are JAX's
  ``MeshPlan.param_spec`` choice, leaf for leaf through the bridge's names,
  at ``configs/car_racer.yaml`` and ``configs/car_racer_64env.yaml`` for m =
  2 and 4 (JAX's state traced with ``jax.eval_shape``, nothing placed).
- Four ranks over gloo on the CPU (one spawn of ``run`` below) at
  ``fake_smoke.yaml`` widened so that weights qualify (GRU 128, so 3H = 384;
  16 x 16 latents, so 256 logits): one ``train_iteration`` in float32 at
  ``[2, 2]`` and at ``[1, 4]`` equals one process's ``n_shards=2``
  (respectively 1) iteration to 1e-5 on the parameters and the moments,
  each sharded weight's moments 1/m of it on every rank, every changed
  weight's version moved; with the weight gather left out (a rank writes
  its own block only), with the returns gathered over the world, and with
  the gather written through ``.data`` it does not.  Through ``Dreamer``: a
  round's ring is bit-equal across a model group (the group's first rank
  steps the envs and broadcasts the rows), and a checkpoint resumes at the
  same mesh bit for bit.
- In process: a checkpoint refuses to restore at another mesh shape of the
  same world size, naming both.
"""

import datetime
import functools
import multiprocessing
import os
import socket
import sys
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.parallel import MeshPlan, make_mesh, model_blocks
from dreamer_tpu_torch.train.step import Trainer
from dreamer_tpu_torch.utils import CheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "fake_smoke.yaml")
# fake_smoke widened so that the GRU's kernels (3H = 384) and the latent
# heads' output layers (16 x 16 = 256) shard over 2 and 4; 4 envs, batch 8.
WIDE = ("wm.hidden_dim=128", "wm.latent_rows=16", "wm.latent_classes=16",
        "env.num_envs=4", "train.batch_size=8", "train.buffer_size=1024")
MESHES = ((2, 2), (1, 4))
WORLD = 4
STEPS = 48          # ring steps an env: three windows of 16
GEN_SEED = 7        # the learner generator's seed, alike on every rank
CRITIC_SCALE = 3.0  # the target critic's output layer, for returns whose range exceeds 1
PARAM_ATOL = 1e-5
SPAWN_TIMEOUT_S = 150


# ---------------------------------------------------------------------- #
# The ranks' side (spawned ranks import this module; JAX is imported only
# inside the test that compares with it).
# ---------------------------------------------------------------------- #

class OwnBlockOnly(MeshPlan):
    """The weight gather left out: a rank writes its own block only."""

    def gather_weights(self, writes):
        with torch.no_grad():
            for p, b, w in writes:
                b.of(p).copy_(w)


class WorldReturns(MeshPlan):
    """The returns gathered over the whole world, not the data group."""

    def gather(self, x):
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world_size)]
        dist.all_gather(parts, x)
        return torch.cat(parts)


class ThroughData(MeshPlan):
    """The weight gather written through ``.data``, which moves no version."""

    def gather_weights(self, writes):
        super().gather_weights([(p.data, b, w) for p, b, w in writes])


PLANS = {"full": MeshPlan, "own_block_only": OwnBlockOnly, "world_returns": WorldReturns,
         "through_data": ThroughData}


def config(overrides=()) -> DreamerConfig:
    return DreamerConfig.from_yaml(SMOKE, overrides=[*WIDE, *overrides])


def ring_data(cfg: DreamerConfig):
    """(obs, action, reward, cont) of every env, ``STEPS`` steps, from a
    numpy seed, with a few episode ends."""
    rng = np.random.default_rng(3)
    E, (h, w), A = cfg.env.num_envs, cfg.wm.obs_size, cfg.env.action_dim
    return (rng.integers(0, 256, (E, STEPS, h, w, 3), dtype=np.uint8),
            rng.uniform(-1, 1, (E, STEPS, A)).astype(np.float32),
            rng.normal(0, 1, (E, STEPS)).astype(np.float32),
            (rng.uniform(size=(E, STEPS)) > 0.1).astype(np.float32))


def build(cfg: DreamerConfig, plan=None, n_shards: int = 1):
    """A trainer, its state (the target critic's output layer scaled) and its
    ring (this rank's data block under a plan)."""
    trainer = Trainer(cfg, device="cpu", seed=cfg.train.seed, plan=plan, n_shards=n_shards)
    state = trainer.init_state()
    with torch.no_grad():
        for p in state.ac.target_critic.denses[-1].parameters():
            p.mul_(CRITIC_SCALE)
    block = slice(None) if plan is None else plan.env_block(cfg.env.num_envs)
    ring = trainer.buffer.add_batch(trainer.init_ring(), *(
        torch.from_numpy(np.ascontiguousarray(d[block])) for d in ring_data(cfg)))
    return trainer, state, ring


def modules(state):
    return (("wm", state.wm.nets), ("actor", state.ac.actor), ("critic", state.ac.critic),
            ("target", state.ac.target_critic))


def optimizers(state):
    return (("wm", state.wm.opt), ("actor", state.ac.actor_opt),
            ("critic", state.ac.critic_opt))


def iterate(plan=None, n_shards=1):
    """One train_iteration from a state whose target critic is scaled (so
    that the returns' range exceeds 1 and the return scale reads their
    quantiles): the parameters, the moments with their blocks, the return
    scale, and the names of the weights whose values changed while their
    version counters did not."""
    trainer, state, ring = build(config(), plan, n_shards)
    before = {f"{m}.{k}": (p.detach().clone(), p._version)
              for m, mod in modules(state) for k, p in mod.named_parameters()}
    state, _ = trainer.train_iteration(state, ring, torch.Generator().manual_seed(GEN_SEED))
    params, silent = {}, []
    for m, mod in modules(state):
        for k, p in mod.named_parameters():
            value, version = before[f"{m}.{k}"]
            params[f"{m}.{k}"] = p.detach().clone()
            if not torch.equal(p, value) and p._version == version:
                silent.append(f"{m}.{k}")
    moments = {}
    for m, opt in optimizers(state):
        blocks = opt.blocks or [None] * len(opt.mu)
        for i, (mu, nu, b) in enumerate(zip(opt.mu, opt.nu, blocks)):
            moments[f"{m}.{i}"] = (mu.clone(), nu.clone(),
                                   None if b is None else (b.axis, b.index, b.parts))
    return {"params": params, "moments": moments, "s_scale": state.ac.s_scale.clone(),
            "silent": silent}


def dreamer_cfg(out_dir, mesh):
    n, m = mesh
    return config((f"runtime.mesh_shape=[{n},{m}]", "runtime.rollout_device=cpu",
                   f"runtime.checkpoint_dir={out_dir}/models_{n}x{m}",
                   f"runtime.log_dir={out_dir}/logs_{n}x{m}"))


def ring_and_resume(out_dir, mesh):
    """Through ``Dreamer``: one random round (the group's first rank steps,
    the others take its rows), one iteration, a checkpoint, and a fresh
    ``Dreamer`` resumed from it.  Returns the ring, whether this rank built
    a farm, and whether the resumed state and ring equal the saved ones."""
    from dreamer_tpu_torch.orchestrator import Dreamer

    d = Dreamer(dreamer_cfg(out_dir, mesh), device="cpu")
    try:
        d.rollout_policy(random_policy=True)
        ring = {k: getattr(d.buf, k).clone() for k in ("obs", "action", "reward", "cont")}
        d.state, _ = d.trainer.train_iteration(d.state, d.buf, d.rng)
        d.iteration = 1
        d.save_checkpoint()
        d.ckpt.wait_until_finished()
        saved = [t.clone() for _, opt in optimizers(d.state) for t in (*opt.mu, *opt.nu)]
        saved += [p.detach().clone() for _, mod in modules(d.state) for p in mod.parameters()]
        farm = d.farm is not None
    finally:
        d.close()
    d2 = Dreamer(dreamer_cfg(out_dir, mesh), device="cpu", resuming=True)
    try:
        assert d2.restore_latest()
        now = [t for _, opt in optimizers(d2.state) for t in (*opt.mu, *opt.nu)]
        now += [p.detach() for _, mod in modules(d2.state) for p in mod.parameters()]
        resumed = (len(now) == len(saved) and all(torch.equal(a, b) for a, b in zip(now, saved))
                   and all(torch.equal(getattr(d2.buf, k), v) for k, v in ring.items())
                   and d2.iteration == 1)
    finally:
        d2.close()
    return {"ring": ring, "farm": farm, "resumed": resumed}


def run(rank: int, port: int, out_dir: str) -> None:
    """Join a gloo group of ``WORLD`` ranks on localhost:``port``, run every
    case at both meshes, and save the results."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(WORLD))
    torch.set_num_threads(1)   # tiny widths; the ranks share the test host's cores
    dist.init_process_group("gloo", rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=90))
    try:
        results = {}
        for mesh in MESHES:
            for name in PLANS:
                plan = PLANS[name](make_mesh(*mesh), "cpu")
                results[mesh, name] = iterate(plan)
                rows = plan.row_block(8)
                results[mesh, name]["rows"] = (rows.start, rows.stop)
            results[mesh, "dreamer"] = ring_and_resume(out_dir, mesh)
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------- #
# JAX's choice of sharded weights
# ---------------------------------------------------------------------- #

@functools.lru_cache(maxsize=None)
def jax_state_and_port_modules(path):
    """JAX's ``DreamerState`` traced at a config (shapes only) and the port's
    world model, actor and critic at its widths, with their bridge entries."""
    import jax

    from dreamer_tpu.config import DreamerConfig as JaxConfig
    from dreamer_tpu.train.step import Trainer as JaxTrainer
    from dreamer_tpu_torch import bridge
    from dreamer_tpu_torch.nets.actor_critic import Actor, Critic
    from dreamer_tpu_torch.nets.wm_nets import WMNets

    file = os.path.join(ROOT, "configs", path)
    jcfg, cfg = JaxConfig.from_yaml(file), DreamerConfig.from_yaml(file)
    state = jax.eval_shape(JaxTrainer(jcfg, jit=False).init_state, jax.random.PRNGKey(0))
    a, in_dim = cfg.agent, cfg.wm.hidden_dim + cfg.wm.latent_dim
    # Only the shapes matter: the truncated-normal draws are skipped.
    with mock.patch("torch.nn.init.trunc_normal_", lambda t, *args, **kwargs: t):
        nets = WMNets(cfg.wm, cfg.env.action_dim, torch.float32)
        actor = Actor(in_dim, cfg.env.action_dim, a.actor_hidden_1, a.actor_hidden_2, a.min_std)
        critic = Critic(in_dim, a.critic_buckets, a.critic_hidden_1, a.critic_hidden_2)
    return state, ((nets, list(bridge._wm_entries(nets)), state.wm.params),
                   (actor, list(bridge._actor_entries(actor)), state.ac.actor_params),
                   (critic, list(bridge._critic_entries(critic)), state.ac.critic_params))


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("path,weights", [("car_racer.yaml", 4_157_400),
                                          ("car_racer_64env.yaml", 9_347_800)])
def test_the_sharded_weights_are_jaxs(path, weights, m):
    import jax
    from jax.sharding import PartitionSpec as P

    from dreamer_tpu.parallel import MeshPlan as JaxPlan
    from dreamer_tpu.parallel import make_mesh as jax_mesh

    state, port = jax_state_and_port_modules(path)
    plan = JaxPlan(jax_mesh(1, m, devices=jax.devices()[:m]))

    def sharded(leaf):
        return plan.param_spec(leaf).spec == P(None, "model")

    def jax_leaf(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    port_total, compared = 0, 0
    for module, entries, tree in port:
        ours = {id(p): b is not None
                for p, b in zip(module.parameters(), model_blocks(module, m, 0))}
        for path_, param, *_ in entries:
            assert ours[id(param)] == sharded(jax_leaf(tree, path_)), "/".join(path_)
            port_total += param.numel() * ours[id(param)]
            compared += 1
        assert compared and len(ours) == sum(1 for _ in module.parameters())
    assert port_total == weights
    # JAX shards the whole state by the rule: the weights with AdamW's mu
    # and nu, three times the weights' elements (no actor or critic weight
    # qualifies at these widths, so the target critic adds none).
    jax_total = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(state)
                    if hasattr(leaf, "ndim") and sharded(leaf))
    assert jax_total == 3 * weights


# ---------------------------------------------------------------------- #
# Four ranks over gloo against one process
# ---------------------------------------------------------------------- #

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Every case on four spawned ranks at both meshes, and each case's
    one-process reference (``n_shards`` = the data axis)."""
    out = tmp_path_factory.mktemp("model_axis")
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=run, args=(r, port, str(out)), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        # The references while the ranks run.
        refs = {n: iterate(n_shards=n) for n in {n for n, _ in MESHES}}
        for p in procs:
            p.join(SPAWN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0] * WORLD, "a rank failed (its traceback is above)"
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=True) for r in range(WORLD)]
    return {"ranks": ranks, "refs": refs}


def gaps(got, ref):
    """The largest |rank - one process| of the parameters and of the moments
    (each rank's block of a sharded weight's against the same block)."""
    params = max(float((got["params"][k] - v).abs().max()) for k, v in ref["params"].items())
    moments = 0.0
    for k, (mu_ref, nu_ref, _) in ref["moments"].items():
        mu, nu, b = got["moments"][k]
        if b is not None:
            axis, index, parts = b
            size = mu_ref.shape[axis] // parts
            mu_ref = mu_ref.narrow(axis, index * size, size)
            nu_ref = nu_ref.narrow(axis, index * size, size)
        moments = max(moments, float((mu - mu_ref).abs().max()), float((nu - nu_ref).abs().max()))
    return params, moments


@pytest.mark.parametrize("mesh", MESHES, ids=["2x2", "1x4"])
def test_a_model_axis_equals_one_process(four_ranks, mesh):
    n, m = mesh
    case = "full"
    ref = four_ranks["refs"][n]
    for r, res in enumerate(four_ranks["ranks"]):
        got = res[mesh, case]
        assert got["rows"] == ((r // m) * 8 // n, (r // m + 1) * 8 // n)
        p_gap, m_gap = gaps(got, ref)
        assert p_gap <= PARAM_ATOL and m_gap <= PARAM_ATOL, (r, p_gap, m_gap)
        torch.testing.assert_close(got["s_scale"], ref["s_scale"], rtol=1e-5, atol=0)
        assert got["silent"] == [], got["silent"]
        # Each sharded weight's moments hold 1/m of it; the weights stay whole.
        sharded = [b for _, _, b in got["moments"].values() if b is not None]
        assert len(sharded) == 4   # the GRU's two kernels, the posterior and prior logits
        assert all(b[1:] == (r % m, m) for b in sharded)
        for k, (mu, nu, b) in got["moments"].items():
            whole = ref["moments"][k][0]
            assert mu.numel() * (m if b is not None else 1) == whole.numel(), k
            assert nu.shape == mu.shape
        assert all(v.shape == ref["params"][k].shape for k, v in got["params"].items())
    assert float(ref["s_scale"]) > 1.0 + 1e-3   # the returns' P95 - P05 exceeds 1
    # The replicated tensors and the gathered weights are bit-equal across
    # the world (every rank ends with one process's weights).
    first = four_ranks["ranks"][0][mesh, case]["params"]
    for res in four_ranks["ranks"][1:]:
        assert all(torch.equal(res[mesh, case]["params"][k], v) for k, v in first.items())


@pytest.mark.parametrize("mesh", MESHES, ids=["2x2", "1x4"])
def test_each_left_out_collective_fails(four_ranks, mesh):
    n, _ = mesh
    ranks = four_ranks["ranks"]
    ref = four_ranks["refs"][n]
    # A rank that writes only its own block keeps the others' old values.
    assert min(gaps(res[mesh, "own_block_only"], ref)[0] for res in ranks) > 4 * PARAM_ATOL
    # Over the world every return appears m times: with 64 returns, 5 % of
    # them is not a whole number, and the quantiles read other values.
    for res in ranks:
        got = float(res[mesh, "world_returns"]["s_scale"])
        assert abs(got - float(ref["s_scale"])) > 1e-4 * float(ref["s_scale"]), got
    # Through .data the weights are right but their version counters stand
    # still, so a layout keyed on them would keep the old weights.
    for res in ranks:
        got = res[mesh, "through_data"]
        assert gaps(got, ref)[0] <= PARAM_ATOL
        assert len(got["silent"]) == 4, got["silent"]


@pytest.mark.parametrize("mesh", MESHES, ids=["2x2", "1x4"])
def test_a_model_group_shares_its_ring_and_resumes(four_ranks, mesh):
    n, m = mesh
    ranks = [res[mesh, "dreamer"] for res in four_ranks["ranks"]]
    assert [r["farm"] for r in ranks] == [r % m == 0 for r in range(WORLD)]
    for r, res in enumerate(ranks):
        first = ranks[(r // m) * m]["ring"]
        assert all(torch.equal(res["ring"][k], v) for k, v in first.items()), r
        assert res["ring"]["obs"].shape[0] == 4 // n
        assert res["resumed"], r
    if n > 1:   # the data blocks step other envs
        assert not torch.equal(ranks[0]["ring"]["obs"], ranks[m]["ring"]["obs"])


# ---------------------------------------------------------------------- #
# The checkpoint's mesh
# ---------------------------------------------------------------------- #

def fake_plan(shape):
    class Plan:   # rank 0 of a mesh, as far as the manager can see
        rank, group_first, mesh_shape = 0, 0, shape
        world_size = shape[0] * shape[1]

        def barrier(self):
            pass

    return Plan()


@pytest.mark.parametrize("saved,run", [((2, 2), (4, 1)), ((2, 1), (1, 2))],
                         ids=["2x2_at_4x1", "2x1_at_1x2"])
def test_a_checkpoint_resumes_only_at_its_mesh(tmp_path, saved, run):
    ckpt = CheckpointManager(str(tmp_path), plan=fake_plan(saved))
    ckpt.save(3, {"iteration": 3, "world_size": saved[0] * saved[1],
                  "mesh_shape": list(saved)}, shard={})
    step, _ = ckpt.restore_latest()
    assert step == 3
    with pytest.raises(ValueError, match=(
            rf"written by {saved[0] * saved[1]} ranks as mesh \[{saved[0]}, {saved[1]}\], "
            rf"this run is {run[0] * run[1]} ranks as mesh \[{run[0]}, {run[1]}\]")):
        CheckpointManager(str(tmp_path), plan=fake_plan(run)).restore_latest()


def test_each_model_axis_mutant_changes_one_line_of_its_source():
    """Each faulty copy that chip_mutants.py builds for the card's model-axis
    update check replaces a text found exactly once in its source."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_mutants",
                                                  os.path.join(ROOT, "chip_mutants.py"))
    mutants = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mutants)
    assert set(mutants.MP_MUTANTS) == {"mp_no_gather", "mp_version", "mp_world_returns"}
    for source, good, bad, checks in mutants.MP_MUTANTS.values():
        with open(os.path.join(ROOT, "dreamer_tpu_torch", source)) as f:
            assert f.read().count(good) == 1 and bad != good
        assert checks == ("model_update",) and "model_update" in mutants.CHECKS


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
