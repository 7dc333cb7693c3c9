"""The overlapped rollout (``runtime.async_rollout`` with the host-local
actor ``runtime.rollout_device='cpu'``) at the ``configs/fake_smoke.yaml``
widths on the CPU, as JAX's ``dreamer.py:981-1050`` and
``tests/test_actor_learner.py`` hold it.

- 4 overlapped iterations fill the ring with every round (2 kickstart + 4),
  and the metrics rows carry only the whole iteration's rates.
- An overlapped run equals, bit for bit, the sequential schedule it
  overlaps: collect with the weights of before the update, update, then
  write.
- A raise in the rollout thread surfaces from ``train()``.

This file imports nothing of JAX, so on the card it runs with
``--noconftest``."""

import csv
import os

import numpy as np
import pytest
import torch

from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.orchestrator import Dreamer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "fake_smoke.yaml")
HOST = {"runtime.rollout_device": "cpu"}
ASYNC = {**HOST, "runtime.async_rollout": True}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the rollout thread and the learner would each
    start a full pool, which on a shared test host spin against each other
    and against the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port(tmp, **kw):
    ov = [f"runtime.checkpoint_dir={tmp}/models", f"runtime.log_dir={tmp}/logs",
          "train.training_iterations=2", "train.random_iterations=1",
          "train.eval_every=100", "train.checkpoint_every=100", "train.eval_episodes=1",
          "train.final_eval_episodes=1", "env.max_episode_steps=10"]
    return Dreamer(DreamerConfig.from_yaml(SMOKE, ov + [f"{k}={v}" for k, v in kw.items()]),
                   device="cpu")


def rows(d):
    with open(os.path.join(d.cfg.runtime.log_dir, "metrics.csv")) as f:
        return [r for r in csv.DictReader(f) if r.get("wm/loss")]


def test_async_training_fills_the_ring_with_every_round(tmp_path):
    kw = {**ASYNC, "train.training_iterations": 4, "train.random_iterations": 2}
    d = port(tmp_path, **kw)
    assert np.isfinite(d.train(progress=False))
    assert d.iteration == 4 and len(d.metrics.wm_losses) == 4
    assert d.buf.size == 6 * d.cfg.train.sequence_length
    # Overlapped, only the whole iteration's rates are logged.
    logged = rows(d)
    assert len(logged) == 4
    for r in logged:
        assert not r.get("perf/rollout_s") and not r.get("perf/learner_s")
        assert float(r["perf/env_steps_per_s"]) > 0 and float(r["perf/grad_updates_per_s"]) > 0


def test_async_run_equals_its_sequential_schedule(tmp_path):
    """Each overlapped iteration collects with the weights of before its
    update, then writes: the same as collecting, updating and writing in
    turn on one thread."""
    kw = {"train.training_iterations": 3, "train.random_iterations": 1}
    d = port(tmp_path / "async", **ASYNC, **kw)
    d.train(progress=False)

    s = port(tmp_path / "seq", **HOST, **kw)
    s.rollout_policy(random_policy=True)
    s.state, _ = s.trainer.wm_step(s.state, s.buf, s.rng)
    s.evaluate_agent(s.cfg.train.eval_episodes)
    for _ in range(kw["train.training_iterations"]):
        s._refresh_actor()
        chunks, _ = s._collect_chunk(False)
        s.state, _ = s.trainer.train_iteration(s.state, s.buf, s.rng)
        s._write_chunk(chunks)
    for name in ("obs", "action", "reward", "cont"):
        assert torch.equal(getattr(d.buf, name), getattr(s.buf, name)), name
    for a, b in zip(d._learner_weights(), s._learner_weights(), strict=True):
        assert torch.equal(a, b)
    assert torch.equal(d.rng.get_state(), s.rng.get_state())


def test_a_raise_in_the_rollout_thread_surfaces_from_train(tmp_path):
    d = port(tmp_path, **ASYNC)
    real, threads = d._collect_chunk, []

    def collect(random_policy):
        import threading

        threads.append(threading.current_thread().name)
        if not random_policy:
            raise RuntimeError("env farm lost")
        return real(random_policy)

    d._collect_chunk = collect
    with pytest.raises(RuntimeError, match="env farm lost"):
        d.train(progress=False)
    assert threads[-1].startswith("rollout")
