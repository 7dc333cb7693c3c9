"""``python -m dreamer_tpu_torch.cli.train`` on the CPU: a short
``configs/fake_smoke.yaml`` schedule (kickstart, 25 training iterations,
evals, checkpoints, final eval, npz) with finite losses and a world-model
loss whose mean over the last 5 iterations is below that over the first 5
(measured: about 366 -> 237 at ``wm.lr=1e-3``); a ``--resume`` run that
continues from the saved iteration with the restored ring; SIGTERM in a
subprocess giving exit 75 and a checkpoint, with the SM_* directories.

One test needs the card (marked ``cuda``; it skips without one): the same
lifecycle at the fake_smoke widths in bfloat16, resumed once, through all
four kernels.  This file imports nothing of JAX, so on the card it runs with
``--noconftest``."""

import csv
import math
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from dreamer_tpu_torch.cli.train import main
from dreamer_tpu_torch.utils.checkpoint import load

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "fake_smoke.yaml")


def dirs(tmp):
    return [f"runtime.checkpoint_dir={tmp}/models", f"runtime.log_dir={tmp}/logs"]


def rows(log_dir, name="metrics.csv"):
    with open(os.path.join(log_dir, name)) as f:
        return [r for r in csv.DictReader(f) if r.get("wm/loss")]


SCHEDULE = ["train.random_iterations=2", "train.eval_every=10", "train.checkpoint_every=10",
            "train.final_eval_episodes=2", "env.max_episode_steps=30", "wm.lr=0.001"]


def test_cli_trains_then_resumes_on_the_cpu(tmp_path):
    argv = ["--config", SMOKE, "--device", "cpu", "--overrides", *dirs(tmp_path), *SCHEDULE]
    final = main(argv + ["train.training_iterations=25"])
    assert math.isfinite(final)
    log_dir, ckpt_dir = tmp_path / "logs", tmp_path / "models"
    first = rows(log_dir)
    assert [int(r["iteration"]) for r in first] == list(range(1, 26))
    for r in first:
        for k in ("wm/loss", "ac/loss_actor", "ac/loss_critic", "perf/env_steps_per_s"):
            assert math.isfinite(float(r[k])), k
    losses = [float(r["wm/loss"]) for r in first]
    assert sum(losses[-5:]) / 5 < sum(losses[:5]) / 5
    assert os.path.exists(log_dir / "training_logs.npz")
    assert os.path.exists(ckpt_dir / "agent_best") and os.path.exists(ckpt_dir / "best.json")
    with open(ckpt_dir / "LATEST") as f:
        assert f.read() == "25"
    size = load(str(ckpt_dir / "ckpt_25"))["buffer"]["size"]
    assert size == (2 + 25) * 16

    main(["--resume"] + argv + ["train.training_iterations=28"])
    resumed = rows(log_dir)
    assert [int(r["iteration"]) for r in resumed] == [26, 27, 28]
    assert [int(r["iteration"]) for r in rows(log_dir, "metrics.leg1.csv")] == list(range(1, 26))
    assert load(str(ckpt_dir / "ckpt_28"))["buffer"]["size"] == size + 3 * 16


def test_sigterm_checkpoints_and_exits_75(tmp_path):
    env = {**os.environ, "SM_MODEL_DIR": str(tmp_path / "models"),
           "SM_OUTPUT_DATA_DIR": str(tmp_path / "logs")}
    cmd = [sys.executable, "-m", "dreamer_tpu_torch.cli.train", "--config", SMOKE,
           "--device", "cpu", "--overrides", "train.training_iterations=100000",
           "train.random_iterations=100000"]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        heartbeat = tmp_path / "logs" / "heartbeat"
        deadline = time.monotonic() + 120
        while not heartbeat.exists() and proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.2)
        assert heartbeat.exists(), "the trainer never started"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 75, out
    assert "Preempted at iter 0 (checkpointed)." in out
    with open(tmp_path / "models" / "LATEST") as f:
        assert f.read() == "0"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_lifecycle_resumes_through_every_kernel_on_card(tmp_path, cuda):
    from dreamer_tpu_torch.ops.conv_cuda import encoder_forward
    from dreamer_tpu_torch.ops.gru_cuda import gru_cell
    from dreamer_tpu_torch.ops.gru_scan_cuda import gru_scan
    from dreamer_tpu_torch.ops.imagine_cuda import imagine_rollout

    kernels = (gru_cell, gru_scan, encoder_forward, imagine_rollout)
    for k in kernels:
        k.launches = 0
    argv = ["--config", SMOKE, "--overrides", *dirs(tmp_path), "runtime.compute_dtype=bfloat16",
            "train.random_iterations=2", "train.eval_every=2", "train.checkpoint_every=2",
            "train.eval_episodes=2", "train.final_eval_episodes=2", "env.max_episode_steps=30"]
    assert math.isfinite(main(argv + ["train.training_iterations=4"]))
    assert math.isfinite(main(["--resume"] + argv + ["train.training_iterations=6"]))
    assert all(k.launches > 0 for k in kernels), [k.launches for k in kernels]
    log_dir = tmp_path / "logs"
    done = rows(log_dir, "metrics.leg1.csv") + rows(log_dir)
    assert [int(r["iteration"]) for r in done] == list(range(1, 7))
    for r in done:
        for k in ("wm/loss", "ac/loss_actor", "ac/loss_critic"):
            assert math.isfinite(float(r[k])), k
