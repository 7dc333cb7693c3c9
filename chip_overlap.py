#!/usr/bin/env python3
"""Measure what the overlapped rollout (``runtime.async_rollout``) gains for
configs/car_racer_64env.yaml's host-local actor on one NVIDIA GPU's host,
at several intra-op thread counts of the training process.

    python3 chip_overlap.py [--iterations 4] [--repeats 2] [--threads 8,6,4]

Each run is ``dreamer_tpu_torch.cli.train.main`` on the configuration as
published (64 envs in AsyncEnvFarm's workers, the float32 host actor fed a
bf16 broadcast, asynchronous checkpoints) on the fake env, with a
12,800-step ring, one kickstart round, ``--iterations`` iterations and no
eval or checkpoint between them; the synchronous and the overlapped run of
each thread count go in turns, their order swapped every repeat.  For each
it prints the medians, over the iterations after the first, of
``perf/env_steps_per_s``, of a policy round and of a ``train_iteration`` to
its last kernel.  Prints the card's name and power limit first; exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import csv
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "car_racer_64env.yaml"
LEG = ("env.env_id=fake", "train.buffer_size=12800", "train.random_iterations=1",
       "train.eval_every=100000", "train.checkpoint_every=100000", "train.eval_episodes=1",
       "train.final_eval_episodes=1")


def run(iterations: int, overlapped: bool, threads: int, tmp: Path) -> dict:
    """One training run; returns its per-iteration times after the first."""
    import torch

    from dreamer_tpu_torch.cli import train as cli
    from dreamer_tpu_torch.orchestrator import dreamer as orch
    from dreamer_tpu_torch.train import step as train_step

    rounds, learner = [], []
    real_collect, real_iteration = orch.Dreamer._collect_chunk, train_step.Trainer.train_iteration

    def collect(self, random_policy):
        start = time.perf_counter()
        out = real_collect(self, random_policy)
        if not random_policy:
            rounds.append(time.perf_counter() - start)
        return out

    def iteration(self, *args):
        start = time.perf_counter()
        out = real_iteration(self, *args)
        torch.cuda.synchronize()
        learner.append(time.perf_counter() - start)
        return out

    logs = tmp / "logs"
    argv = ["--config", str(CONFIG), "--overrides", *LEG,
            f"train.training_iterations={iterations}",
            f"runtime.async_rollout={str(overlapped).lower()}",
            f"runtime.checkpoint_dir={tmp / 'models'}", f"runtime.log_dir={logs}"]
    default = torch.get_num_threads()
    orch.Dreamer._collect_chunk, train_step.Trainer.train_iteration = collect, iteration
    torch.set_num_threads(threads)
    try:
        cli.main(argv)
    finally:
        torch.set_num_threads(default)
        orch.Dreamer._collect_chunk = real_collect
        train_step.Trainer.train_iteration = real_iteration
    with open(logs / "metrics.csv") as f:
        rows = [r for r in csv.DictReader(f) if r.get("wm/loss")]
    if len(rows) != iterations or len(rounds) != iterations or len(learner) != iterations:
        raise RuntimeError(f"expected {iterations} iterations, saw {len(rows)} rows, "
                           f"{len(rounds)} rounds, {len(learner)} updates")
    return {"env_steps_per_s": [float(r["perf/env_steps_per_s"]) for r in rows[1:]],
            "round_s": rounds[1:], "learner_s": learner[1:]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_overlap: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iterations", type=int, default=4)
    parser.add_argument("--repeats", type=int, default=2)
    parser.add_argument("--threads", type=str, default="8,6,4",
                        help="intra-op thread counts of the training process")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    threads = [int(t) for t in args.threads.split(",")]
    samples = {(t, o): {"env_steps_per_s": [], "round_s": [], "learner_s": []}
               for t in threads for o in (False, True)}
    with tempfile.TemporaryDirectory() as tmp:
        for rep in range(args.repeats):
            for t in threads:
                for overlapped in ((False, True) if rep % 2 == 0 else (True, False)):
                    where = Path(tmp) / f"r{rep}_t{t}_{int(overlapped)}"
                    got = run(args.iterations, overlapped, t, where)
                    for k, v in got.items():
                        samples[(t, overlapped)][k] += v
                    print(f"chip_overlap: repeat {rep} threads {t} "
                          f"{'overlapped' if overlapped else 'synchronous'}: env steps/s "
                          + " ".join(f"{x:.2f}" for x in got["env_steps_per_s"])
                          + "; round s " + " ".join(f"{x:.4f}" for x in got["round_s"])
                          + "; learner s " + " ".join(f"{x:.4f}" for x in got["learner_s"]),
                          flush=True)
    for (t, overlapped), s in samples.items():
        print(f"chip_overlap: threads {t} {'overlapped ' if overlapped else 'synchronous'}: "
              f"median env steps/s {statistics.median(s['env_steps_per_s']):.2f} (of "
              f"{len(s['env_steps_per_s'])}, min {min(s['env_steps_per_s']):.2f}, max "
              f"{max(s['env_steps_per_s']):.2f}), a policy round "
              f"{statistics.median(s['round_s']):.4f} s, a train_iteration to its last kernel "
              f"{statistics.median(s['learner_s']):.4f} s on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
