"""The port's asynchronous checkpoints (``runtime.async_checkpoint``,
``CheckpointManager(use_async=True)``; JAX's orbax ``AsyncCheckpointer``) on
the CPU.  The writer is held back (``atomic_save`` waits for the test, or
sleeps first), so that each check sees what happens while a write is in
flight.

- ``save`` returns before the file lands, from a snapshot: tensors changed
  in place after it returns do not reach the file.
- Saves land in order, each after the one before; after the wait ``LATEST``
  names the newest and only the newest ``keep_last`` remain.
- A write that raises is raised at the next ``save``, ``wait_until_finished``
  or restore, once, never swallowed.
- A run resumed from its asynchronous checkpoints equals one resumed from
  synchronous checkpoints of the same schedule, bit for bit.
- SIGTERM: ``cli.train.main`` exits 75 only after the stop's checkpoint and
  ``LATEST`` are on disk.

This file imports nothing of JAX, so on the card it runs with
``--noconftest``."""

import os
import signal
import threading
import time

import pytest
import torch

from dreamer_tpu_torch.cli import train as cli
from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.orchestrator import Dreamer
from dreamer_tpu_torch.utils import CheckpointManager
from dreamer_tpu_torch.utils import checkpoint as ckpt_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "fake_smoke.yaml")
DELAY_S = 0.3


@pytest.fixture
def slow_writer(monkeypatch):
    """``atomic_save`` that sleeps first and logs each (path, thread) it writes."""
    real, log = ckpt_mod.atomic_save, []

    def slow(obj, path):
        time.sleep(DELAY_S)
        log.append((os.path.basename(path), threading.current_thread().name))
        real(obj, path)

    monkeypatch.setattr(ckpt_mod, "atomic_save", slow)
    return log


def test_save_returns_before_the_write_from_a_snapshot(tmp_path, monkeypatch):
    # The write waits until the test has changed the tensors in place.
    real, gate, writers = ckpt_mod.atomic_save, threading.Event(), []

    def gated(obj, path):
        assert gate.wait(timeout=60)
        writers.append(threading.current_thread().name)
        real(obj, path)

    monkeypatch.setattr(ckpt_mod, "atomic_save", gated)
    m = CheckpointManager(str(tmp_path), use_async=True)
    ring = torch.arange(1000, dtype=torch.float32)
    tree = {"ring": ring, "opt": {"mu": [torch.ones(3)]}, "step": 7}
    path = m.save(7, tree)
    assert not os.path.exists(path)
    ring.mul_(-1)            # what the next round and update do in place
    tree["opt"]["mu"][0].zero_()
    gate.set()
    m.wait_until_finished()
    saved = ckpt_mod.load(path)
    assert torch.equal(saved["ring"], torch.arange(1000, dtype=torch.float32))
    assert torch.equal(saved["opt"]["mu"][0], torch.ones(3)) and saved["step"] == 7
    assert len(writers) == 1 and writers[0] != threading.current_thread().name
    record = m.timings[-1]
    assert record["returned_at"] < record["landed_at"]
    m.close()


def test_saves_land_in_order_then_latest_and_pruning(tmp_path, slow_writer):
    m = CheckpointManager(str(tmp_path), keep_last=2, use_async=True)
    for step in (1, 2, 3):
        m.save(step, {"step": torch.tensor(step)})
        # Each save waited for the one before: the previous file is on disk.
        if step > 1:
            assert os.path.exists(os.path.join(str(tmp_path), f"ckpt_{step - 1}"))
    assert m.latest_step() == 3   # waits first
    assert [name for name, _ in slow_writer] == ["ckpt_1", "ckpt_2", "ckpt_3"]
    assert sorted(n for n in os.listdir(tmp_path) if n.startswith("ckpt_")) == ["ckpt_2",
                                                                               "ckpt_3"]
    step, tree = m.restore_latest()
    assert step == 3 and int(tree["step"]) == 3
    m.close()


@pytest.mark.parametrize("then", ["save", "wait", "restore"])
def test_a_write_error_is_raised_once(tmp_path, monkeypatch, then):
    m = CheckpointManager(str(tmp_path), use_async=True)
    m.save(1, {"x": torch.ones(2)})
    m.wait_until_finished()

    def full_disk(obj, path):
        time.sleep(DELAY_S)
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(ckpt_mod, "atomic_save", full_disk)
    m.save(2, {"x": torch.zeros(2)})
    act = {"save": lambda: m.save(3, {"x": torch.ones(2)}), "wait": m.wait_until_finished,
           "restore": m.restore_latest}[then]
    with pytest.raises(OSError, match="No space left"):
        act()
    # Raised once; the last checkpoint that landed is still the newest.
    m.wait_until_finished()
    assert m.latest_step() == 1
    m.close()


def config(tmp, **kw):
    ov = [f"runtime.checkpoint_dir={tmp}/models", f"runtime.log_dir={tmp}/logs",
          "env.max_episode_steps=10", "train.training_iterations=1",
          "train.random_iterations=1", "train.checkpoint_every=1", "train.eval_every=100",
          "train.eval_episodes=1", "train.final_eval_episodes=1"]
    return DreamerConfig.from_yaml(SMOKE, ov + [f"{k}={v}" for k, v in kw.items()])


def everything(d):
    s, b = d.state, d.buf
    out = {f"wm.{k}": v for k, v in s.wm.nets.state_dict().items()}
    for name, mod in (("actor", s.ac.actor), ("critic", s.ac.critic),
                      ("target", s.ac.target_critic)):
        out.update({f"{name}.{k}": v for k, v in mod.state_dict().items()})
    for name, opt in (("wm_opt", s.wm.opt), ("actor_opt", s.ac.actor_opt),
                      ("critic_opt", s.ac.critic_opt)):
        out.update({f"{name}.mu{i}": t for i, t in enumerate(opt.mu)})
        out.update({f"{name}.nu{i}": t for i, t in enumerate(opt.nu)})
        out[f"{name}.count"] = opt.count
    out.update({"s_scale": s.ac.s_scale, "step": s.step, "obs": b.obs, "action": b.action,
                "reward": b.reward, "cont": b.cont, "rng": d.rng.get_state(),
                "rollout_rng": d.rollout_rng.get_state()})
    return out, (b.next_idx, b.size, d.iteration, d.farm.seed, d._eval_seed)


def test_a_resume_from_async_checkpoints_equals_one_from_sync(tmp_path, slow_writer):
    resumed = []
    for mode in ("true", "false"):
        kw = {"runtime.async_checkpoint": mode}
        d = Dreamer(config(tmp_path / mode, **kw), device="cpu")
        d.train(progress=False)
        d.close()
        r = Dreamer(config(tmp_path / mode, **kw), device="cpu")
        assert r.restore_latest() and r.iteration == 1
        resumed.append(everything(r))
        r.close()
    (a, a_n), (b, b_n) = resumed
    assert a_n == b_n and set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # The async run's three saves (kickstart, iteration 1, the end) went
    # through the writer thread, the sync run's did not.
    assert [t.startswith("checkpoint") for _, t in slow_writer] == [True] * 3 + [False] * 3


def test_sigterm_exits_75_after_the_checkpoint_lands(tmp_path, slow_writer, monkeypatch):
    models, logs = tmp_path / "models", tmp_path / "logs"
    seen = {}
    real_train = Dreamer.train

    def train(self, *args, **kwargs):
        # SIGTERM arrives while the first iteration is under way.
        real_iteration = self.trainer.train_iteration

        def iteration(*a):
            os.kill(os.getpid(), signal.SIGTERM)
            return real_iteration(*a)

        self.trainer.train_iteration = iteration
        out = real_train(self, *args, **kwargs)
        seen["landed"] = (models / "ckpt_1").exists()
        with open(models / "LATEST") as f:
            seen["latest"] = f.read()
        return out

    monkeypatch.setattr(Dreamer, "train", train)
    argv = ["--config", SMOKE, "--device", "cpu", "--overrides",
            f"runtime.checkpoint_dir={models}", f"runtime.log_dir={logs}",
            "runtime.async_checkpoint=true", "train.training_iterations=5",
            "train.random_iterations=1", "train.eval_episodes=1", "env.max_episode_steps=10"]
    with pytest.raises(SystemExit) as stop:
        cli.main(argv)
    assert stop.value.code == 75
    assert seen == {"landed": True, "latest": "1"}
    assert ckpt_mod.load(str(models / "ckpt_1"))["iteration"] == 1
