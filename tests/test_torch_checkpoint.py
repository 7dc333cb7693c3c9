"""The port's checkpoints (``utils.checkpoint``, ``Dreamer.save_checkpoint``
and ``restore_latest``) and its copy of the metrics logger, on the CPU.

- A save then a restore into a Dreamer built from another seed brings back
  every tensor of the training state, the replay ring and every counter bit
  for bit, and the restored generators continue the saved streams: the next
  ``train_iteration`` and rollout round give the same metrics and ring.
- ``keep_last`` pruning and the ``LATEST`` pointer; a save cut off mid-write
  leaves the previous checkpoint and pointer readable.
- ``agent_best``: a weights-only export that loads back.
- ``MetricsLogger`` writes the CSV and npz that the JAX package's writes for
  the same calls, and rotates existing files the same way.  Exact, except the
  wall-time column."""

import csv
import os

import numpy as np
import pytest
import torch

from dreamer_tpu.utils.metrics import MetricsLogger as JaxMetricsLogger
from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.orchestrator import Dreamer
from dreamer_tpu_torch.utils import CheckpointManager, MetricsLogger
from dreamer_tpu_torch.utils import checkpoint as ckpt_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "fake_smoke.yaml")


def port(tmp, **kw):
    ov = [f"runtime.checkpoint_dir={tmp}/models", f"runtime.log_dir={tmp}/logs",
          "env.max_episode_steps=10"] + [f"{k}={v}" for k, v in kw.items()]
    return Dreamer(DreamerConfig.from_yaml(SMOKE, ov), device="cpu")


def tensors(d):
    """Every tensor and counter a checkpoint restores, by name."""
    s, b = d.state, d.buf
    out = {f"wm.{k}": v for k, v in s.wm.nets.state_dict().items()}
    for name, m in (("actor", s.ac.actor), ("critic", s.ac.critic),
                    ("target", s.ac.target_critic)):
        out.update({f"{name}.{k}": v for k, v in m.state_dict().items()})
    for name, opt in (("wm_opt", s.wm.opt), ("actor_opt", s.ac.actor_opt),
                      ("critic_opt", s.ac.critic_opt)):
        out.update({f"{name}.mu{i}": t for i, t in enumerate(opt.mu)})
        out.update({f"{name}.nu{i}": t for i, t in enumerate(opt.nu)})
        out[f"{name}.count"] = opt.count
    out.update({"s_scale": s.ac.s_scale, "step": s.step, "obs": b.obs, "action": b.action,
                "reward": b.reward, "cont": b.cont, "rng": d.rng.get_state(),
                "rollout_rng": d.rollout_rng.get_state()})
    counters = {"next_idx": b.next_idx, "size": b.size, "iteration": d.iteration,
                "env_seed": d.farm.seed, "eval_seed": d._eval_seed}
    return out, counters


def test_save_restore_round_trips_bit_for_bit(tmp_path):
    d = port(tmp_path / "a", **{"env.num_envs": 2})
    for _ in range(2):
        d.rollout_policy(random_policy=True)
    d.state, _ = d.trainer.train_iteration(d.state, d.buf, d.rng)
    d.iteration = 1
    d.evaluate_agent(2, max_steps=5)
    d.save_checkpoint()

    d2 = port(tmp_path / "a", **{"env.num_envs": 2, "train.seed": 7})
    assert d2.restore_latest()
    (want, want_n), (got, got_n) = tensors(d), tensors(d2)
    assert got_n == want_n
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    # Continuing: the same streams, so the same updates and the same ring.
    m1 = d.trainer.train_iteration(d.state, d.buf, d.rng)[1]
    m2 = d2.trainer.train_iteration(d2.state, d2.buf, d2.rng)[1]
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    d._obs = None   # restore starts new episodes; so does the original here
    r1, r2 = d.rollout_policy(), d2.rollout_policy()
    assert r1 == r2
    (want, _), (got, _) = tensors(d), tensors(d2)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_restore_without_a_checkpoint_returns_false(tmp_path):
    assert not port(tmp_path).restore_latest()


def test_checkpoint_without_the_ring_keeps_a_fresh_ring(tmp_path):
    d = port(tmp_path, **{"runtime.checkpoint_replay": False})
    d.rollout_policy(random_policy=True)
    d.save_checkpoint()
    assert "buffer" not in ckpt_mod.load(os.path.join(d.cfg.runtime.checkpoint_dir, "ckpt_0"))
    d2 = port(tmp_path)
    assert d2.restore_latest() and not d2._ring_restored and d2.buf.size == 0


def test_pruning_and_latest(tmp_path):
    m = CheckpointManager(str(tmp_path), keep_last=3)
    assert m.latest_step() is None and m.restore_latest() is None
    for step in (5, 10, 15, 20, 25):
        m.save(step, {"step": step, "x": torch.full((3,), float(step))})
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "ckpt_15", "ckpt_20", "ckpt_25"]
    step, tree = m.restore_latest()
    assert step == 25 and tree["step"] == 25 and torch.equal(tree["x"], torch.full((3,), 25.0))


def test_a_save_cut_off_mid_write_leaves_the_previous_checkpoint(tmp_path, monkeypatch):
    m = CheckpointManager(str(tmp_path))
    m.save(1, {"x": torch.ones(4)})
    real = torch.save

    def cut_off(obj, f):
        f.write(b"partial bytes")
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.torch, "save", cut_off)
    with pytest.raises(OSError):
        m.save(2, {"x": torch.zeros(4)})
    assert m.latest_step() == 1 and not os.path.exists(tmp_path / "ckpt_2")
    step, tree = m.restore_latest()
    assert step == 1 and torch.equal(tree["x"], torch.ones(4))
    monkeypatch.setattr(ckpt_mod.torch, "save", real)
    m.save(2, {"x": torch.zeros(4)})
    assert m.latest_step() == 2 and torch.equal(m.restore(2)["x"], torch.zeros(4))


def test_agent_export_loads_back(tmp_path):
    d = port(tmp_path)
    d._maybe_save_best(1.5)
    d._maybe_save_best(0.5)   # not better: no export
    with open(os.path.join(d.cfg.runtime.checkpoint_dir, "best.json")) as f:
        assert f.read() == '{"iteration": 0, "eval_reward": 1.5}'
    d2 = port(tmp_path / "other", **{"train.seed": 9})
    before = [p.clone() for p in d2.state.ac.actor.parameters()]
    d2.load_agent(os.path.join(d.cfg.runtime.checkpoint_dir, "agent_best"))
    for a, b in zip(d.state.wm.nets.parameters(), d2.state.wm.nets.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(d.state.ac.critic.parameters(), d2.state.ac.critic.parameters()):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(before, d2.state.ac.actor.parameters()))


def _log(cls, log_dir, resuming):
    m = cls(str(log_dir), resuming=resuming)
    m.log_iteration(1, {"wm/loss": np.float32(2.5), "wm/loss_epochs": np.array([3.0, 2.5]),
                        "ac/loss_actor": np.float32(-0.25), "ac/loss_critic": 4.0,
                        "perf/env_steps_per_s": 123.5})
    m.log_eval(1, 7.25)
    m.log_iteration(2, {"wm/loss": 2.0, "ac/loss_actor": 0.5, "ac/loss_critic": 3.0,
                        "extra/new_key": 1.0})
    m.save_npz()
    m.close()


def _read(log_dir):
    with open(os.path.join(log_dir, "metrics.csv")) as f:
        rows = [{k: v for k, v in r.items() if k != "wall_time"} for r in csv.DictReader(f)]
    with np.load(os.path.join(log_dir, "training_logs.npz")) as z:
        return rows, {k: z[k] for k in z.files}


@pytest.mark.parametrize("resuming", [True, False], ids=["resume", "fresh"])
def test_metrics_logger_writes_what_jax_writes(tmp_path, resuming):
    for cls, sub in ((MetricsLogger, "port"), (JaxMetricsLogger, "jax")):
        _log(cls, tmp_path / sub, True)
        _log(cls, tmp_path / sub, resuming)   # rotates the first run's files
    got, want = _read(tmp_path / "port"), _read(tmp_path / "jax")
    assert got[0] == want[0] and len(got[0]) == 3
    assert set(got[1]) == set(want[1]) == {"world_model_loss", "actor_loss", "critic_loss",
                                           "rewards"}
    for k in want[1]:
        assert got[1][k].dtype == want[1][k].dtype
        np.testing.assert_array_equal(got[1][k], want[1][k])
    tag = "leg" if resuming else "stale"
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == \
        sorted([f"metrics.{tag}1.csv", "metrics.csv", f"training_logs.{tag}1.npz",
                "training_logs.npz"])
