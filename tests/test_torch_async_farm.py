"""The port's subprocess env farm (``dreamer_tpu_torch.envs.AsyncEnvFarm``)
against the JAX package's (``dreamer_tpu/envs/vector.py:99-156``, on
gymnasium's ``AsyncVectorEnv``), exactly, and its failures.

- On the fake env with episodes of 3 and 5 steps, in both auto-reset modes:
  ``reset_all``, every ``step``'s four arrays (values and dtypes),
  ``sample_actions`` and the seed counter equal JAX's over 12 steps and a
  second ``reset_all``.
- The workers are spawned processes of their own, each with one BLAS and
  one OpenMP thread (the parent's environment untouched); ``close()`` joins
  them.  Importing ``dreamer_tpu_torch.envs``, as each worker does, loads
  no torch.
- A worker's exception is raised in the parent with the worker's
  traceback; a worker that dies or does not answer within the farm's
  timeout raises; neither hangs.
- The port's ``Dreamer`` with ``env.async_envs=true`` at the
  ``configs/fake_smoke.yaml`` widths fills the kickstart ring that the JAX
  ``Dreamer`` with the same knob fills (the pattern of
  ``test_torch_orchestrator.py::test_kickstart_ring_equals_jax``; rewards to
  2 ulp for the reason given there); its eval stays on the in-process farm.

Every factory is a ``functools.partial`` of a module-level callable, as
``spawn`` needs."""

import functools
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest

from _torch_farm_envs import DyingEnv, HangingEnv, RaisingEnv, ThreadsEnv, broken_factory
from dreamer_tpu.config import DreamerConfig as JaxConfig
from dreamer_tpu.envs import AsyncEnvFarm as JaxAsyncEnvFarm
from dreamer_tpu.envs.fake import FakeEnv as JaxFakeEnv
from dreamer_tpu.orchestrator import Dreamer as JaxDreamer
from dreamer_tpu.train.step import Trainer as JaxTrainer
from dreamer_tpu_torch import bridge
from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.envs import AsyncEnvFarm, EnvFarm, FakeEnv
from dreamer_tpu_torch.orchestrator import Dreamer
from test_torch_orchestrator import SMOKE, overrides, random_init_state

LENS = (3, 5)
STEPS = 12


def fns(cls, **kw):
    return [functools.partial(cls, obs_size=(16, 24), episode_len=n, **kw) for n in LENS]


@pytest.mark.parametrize("next_step", [False, True], ids=["same_step", "next_step"])
def test_async_farm_equals_jax(next_step):
    farm = AsyncEnvFarm(fns(FakeEnv), seed=7, next_step=next_step)
    try:
        ref = JaxAsyncEnvFarm(fns(JaxFakeEnv), seed=7, next_step=next_step)
        try:
            pids = {p.pid for p in farm.workers}
            assert {type(p).__name__ for p in farm.workers} == {"SpawnProcess"}
            assert len(pids) == len(LENS) and os.getpid() not in pids
            np.testing.assert_array_equal(farm.reset_all(), ref.reset_all())
            assert farm.seed == ref.seed == 7 + len(LENS)
            rng = np.random.default_rng(2)
            firsts = 0
            for step in range(STEPS):
                if step % 2:
                    actions = rng.uniform(-1, 1, (len(LENS), 3)).astype(np.float32)
                else:
                    actions = farm.sample_actions()
                    want = ref.sample_actions()
                    assert actions.dtype == want.dtype == np.float32
                    np.testing.assert_array_equal(actions, want)
                out, want = farm.step(actions), ref.step(actions)
                for a, b in zip(out, want):
                    assert a.dtype == b.dtype and a.shape == b.shape
                    np.testing.assert_array_equal(a, b)
                firsts += int(out[3].sum())
            assert firsts >= 4   # both envs reset at least twice
            assert farm.seed == ref.seed   # auto-resets draw no seed
            np.testing.assert_array_equal(farm.reset_all(), ref.reset_all())
            assert farm.seed == ref.seed == 7 + 2 * len(LENS)
        finally:
            ref.close()
    finally:
        farm.close()
    assert not any(p.is_alive() for p in farm.workers)


@pytest.mark.parametrize("factory,kw,error,match", [
    (RaisingEnv, {"fail_at": 2}, RuntimeError, "FloatingPointError: the physics blew up at step 2"),
    (DyingEnv, {}, RuntimeError, "died with exit code 3"),
    (HangingEnv, {}, TimeoutError, "did not answer within 1 s"),
], ids=["raises", "dies", "hangs"])
def test_a_failing_worker_raises_in_the_parent(factory, kw, error, match):
    farm = AsyncEnvFarm([functools.partial(FakeEnv, obs_size=(8, 8)),
                         functools.partial(factory, obs_size=(8, 8), **kw)], seed=0)
    try:
        farm.reset_all()
        farm.timeout = 1.0   # after the workers' start, which may take longer
        start = time.monotonic()
        with pytest.raises(error, match=match):
            for _ in range(3):
                farm.step(np.zeros((2, 3), np.float32))
        assert time.monotonic() - start < 30
        with pytest.raises(RuntimeError, match="closed"):
            farm.reset_all()
    finally:
        farm.close()
    assert not any(p.is_alive() for p in farm.workers)


def test_workers_run_one_blas_and_openmp_thread(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "8")
    monkeypatch.delenv("OPENBLAS_NUM_THREADS", raising=False)
    farm = AsyncEnvFarm([functools.partial(ThreadsEnv, obs_size=(8, 8))] * 2, seed=0)
    try:
        farm.reset_all()
        np.testing.assert_array_equal(farm.step(np.zeros((2, 3), np.float32))[1], [11, 11])
    finally:
        farm.close()
    assert os.environ["OMP_NUM_THREADS"] == "8" and "OPENBLAS_NUM_THREADS" not in os.environ


def test_importing_the_envs_loads_no_torch():
    code = "import sys, dreamer_tpu_torch.envs; sys.exit('torch' in sys.modules)"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert subprocess.run([sys.executable, "-c", code], cwd=root, timeout=120).returncode == 0


def test_a_factory_that_raises_is_named():
    with pytest.raises(RuntimeError, match="ImportError: no module named 'box2d'"):
        AsyncEnvFarm([broken_factory], seed=0)


def test_dreamer_with_async_envs_fills_the_kickstart_ring_of_jax(tmp_path, monkeypatch):
    kw = {"env.async_envs": True, "env.max_episode_steps": 12}
    monkeypatch.setattr(JaxTrainer, "init_state", random_init_state)
    jd = JaxDreamer(JaxConfig.from_yaml(SMOKE, overrides(tmp_path / "jax", **kw)))
    try:
        d = Dreamer(DreamerConfig.from_yaml(SMOKE, overrides(tmp_path / "port", **kw)),
                    device="cpu")
        try:
            assert isinstance(d.farm, AsyncEnvFarm)
            assert {type(p).__name__ for p in d.farm.workers} == {"SpawnProcess"}
            bridge.load_dreamer_state(d.state, jax.tree.map(np.asarray, jd.state))
            for _ in range(2):
                jd.rollout_policy(random_policy=True)
                d.rollout_policy(random_policy=True)
            jb, b = jd.buf, d.buf
            for name in ("obs", "action", "cont"):
                np.testing.assert_array_equal(getattr(b, name).numpy(),
                                              np.asarray(getattr(jb, name)), err_msg=name)
            np.testing.assert_array_max_ulp(b.reward.numpy(), np.asarray(jb.reward), maxulp=2)
            assert (b.next_idx, b.size) == (int(jb.next_idx), int(jb.size)) == (32, 32)
            assert float(b.cont.min()) == 0.0   # episodes of 12 steps ended in the ring
            assert d.farm.seed == jd.farm.seed == 2   # one reset_all of 2 envs
            assert np.isfinite(d.evaluate_agent(1, max_steps=5))
            assert isinstance(d._eval_farm, EnvFarm)
        finally:
            d.close()
    finally:
        jd.farm.close()
