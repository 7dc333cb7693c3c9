"""The port's learning gate, ``tests/test_learning.py`` with the same settings
and thresholds: two seeds of 700 iterations on the deterministic fake env
(``configs/fake_smoke.yaml``, ``agent.min_std=0.1``, 10 kickstart rounds
each followed by a world-model step).  Per seed the mean world-model loss of
the last 10 iterations must be under half that of the first 10; across the
seeds the mean ratio of the late evals (iterations 500, 600 and 700, 8
episodes of up to 110 steps each) to the eval after the kickstart must
exceed 1.1.

Both tests are ``slow``.  The first runs on the CPU in float32; its twin
(``cuda``) runs on the card in bfloat16 through the four kernels.  Each
prints its ratios and seconds.  This file imports nothing of JAX, so on the
card it runs with ``--noconftest``."""

import os
import time

import numpy as np
import pytest
import torch

from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.orchestrator import Dreamer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "fake_smoke.yaml")
SEEDS = (0, 1)
ITERATIONS = 700
EVAL_EPISODES, EVAL_STEPS = 8, 110


def run_seed(tmp_path, seed, device, extra=()):
    """Train ``ITERATIONS`` iterations; returns (eval after the kickstart,
    late evals, world-model losses, seconds)."""
    start = time.perf_counter()
    cfg = DreamerConfig.from_yaml(SMOKE, overrides=[
        f"runtime.checkpoint_dir={tmp_path}/seed{seed}/models",
        f"runtime.log_dir={tmp_path}/seed{seed}/logs",
        f"train.training_iterations={ITERATIONS}", "train.random_iterations=10",
        "train.eval_every=1000", "train.checkpoint_every=1000", f"train.seed={seed}",
        "agent.min_std=0.1", *extra])
    d = Dreamer(cfg, device=device)
    try:
        for _ in range(cfg.train.random_iterations):
            d.rollout_policy(random_policy=True)
            d.state, _ = d.trainer.wm_step(d.state, d.buf, d.rng)
        eval_before = d.evaluate_agent(EVAL_EPISODES, max_steps=EVAL_STEPS)
        wm_losses, late_evals = [], []
        for i in range(cfg.train.training_iterations):
            d.rollout_policy(random_policy=False)
            d.state, m = d.trainer.train_iteration(d.state, d.buf, d.rng)
            wm_losses.append(float(m["wm/loss"]))
            if (i + 1) % 100 == 0 and i + 1 >= 500:
                late_evals.append(d.evaluate_agent(EVAL_EPISODES, max_steps=EVAL_STEPS))
    finally:
        d.close()
    return eval_before, late_evals, wm_losses, time.perf_counter() - start


def gate(tmp_path, device, extra=()):
    ratios = []
    for seed in SEEDS:
        eval_before, late_evals, wm_losses, seconds = run_seed(tmp_path, seed, device, extra)
        wm_ratio = float(np.mean(wm_losses[-10:]) / np.mean(wm_losses[:10]))
        ratios.append(float(np.mean(late_evals)) / eval_before)
        print(f"learning gate on {device}, seed {seed}: eval {eval_before:.3f} -> late "
              f"{[round(e, 3) for e in late_evals]} (ratio {ratios[-1]:.4f}); WM loss last 10 "
              f"/ first 10 = {wm_ratio:.4f}; {seconds:.1f} s", flush=True)
        assert np.mean(wm_losses[-10:]) < 0.5 * np.mean(wm_losses[:10]), \
            (seed, wm_losses[::50])
    print(f"learning gate on {device}: mean eval ratio {np.mean(ratios):.4f} over seeds "
          f"{SEEDS}", flush=True)
    assert float(np.mean(ratios)) > 1.1, ratios


@pytest.mark.slow
def test_wm_loss_decreases_and_eval_improves(tmp_path):
    gate(tmp_path, "cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.slow
@pytest.mark.cuda
def test_wm_loss_decreases_and_eval_improves_on_card(tmp_path, cuda):
    gate(tmp_path, cuda, ("runtime.compute_dtype=bfloat16",))
