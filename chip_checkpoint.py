#!/usr/bin/env python3
"""Time the port's checkpoint saves at configs/car_racer_64env.yaml's
published replay ring (512,000 steps, 8,000 an env for 64 envs, about 6.3 GB
of frames) on one NVIDIA GPU.

    python3 chip_checkpoint.py [--ring-steps N]

Builds the port's ``Dreamer`` at the configuration's widths on the card (64
in-process fake envs: the save does not depend on the envs), fills the
ring's frames, and times, in one temporary directory:

- two asynchronous saves (``runtime.async_checkpoint``): the part that blocks
  (the snapshot into pinned host memory; the first save also allocates it)
  and the write on the writer thread;
- one synchronous save (``torch.save``, flush, ``fsync``, rename).

Then restores the newest checkpoint and holds its ring's frames equal to the
card's.  Prints the card's name and power limit first and the bytes, seconds
and rates of each save; exits non-zero on any failure or without a card.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "car_racer_64env.yaml"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_checkpoint: no CUDA device", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ring-steps", type=int, default=None,
                        help="train.buffer_size (default: the configuration's)")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import subprocess

    from dreamer_tpu_torch.config import DreamerConfig
    from dreamer_tpu_torch.orchestrator import Dreamer
    from dreamer_tpu_torch.utils import CheckpointManager

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        overrides = ["env.env_id=fake", "env.async_envs=false",
                     f"runtime.checkpoint_dir={tmp}/models", f"runtime.log_dir={tmp}/logs"]
        if args.ring_steps:
            overrides.append(f"train.buffer_size={args.ring_steps}")
        cfg = DreamerConfig.from_yaml(str(CONFIG), overrides)
        d = Dreamer(cfg)
        d.ckpt.keep_last = 1   # one 6 GB file on disk at a time, two while it is replaced
        b = d.buf
        gen = torch.Generator(device="cuda").manual_seed(0)
        b.obs.copy_(torch.randint(0, 256, b.obs.shape, dtype=torch.uint8, device="cuda",
                                  generator=gen))
        b.size = b.next_idx = b.obs.shape[1]
        ring_gb = sum(t.numel() * t.element_size() for t in (b.obs, b.action, b.reward,
                                                             b.cont)) / 1e9
        tree_gb = None
        for i, mode in enumerate(("async", "async", "sync")):
            ckpt = d.ckpt if mode == "async" else CheckpointManager(
                cfg.runtime.checkpoint_dir, keep_last=1, use_async=False)
            d.iteration = i
            torch.cuda.synchronize()
            start = time.perf_counter()
            path = ckpt.save(d.iteration, d._checkpoint_tree())
            returned = time.perf_counter() - start
            ckpt.wait_until_finished()
            total = time.perf_counter() - start
            rec = ckpt.timings[-1]
            tree_gb = os.path.getsize(path) / 1e9
            write = rec.get("write_s", total)
            print(f"chip_checkpoint: {mode} save {i}: {tree_gb:.3f} GB file (ring "
                  f"{ring_gb:.3f} GB, {cfg.train.buffer_size} steps); save() returned after "
                  f"{returned * 1e3:.1f} ms (blocking {rec['blocking_s'] * 1e3:.1f} ms"
                  + (", the pinned buffers allocated" if mode == "async" and i == 0 else "")
                  + f"), the write took {write * 1e3:.1f} ms ({tree_gb / write:.2f} GB/s), "
                  f"landed {total * 1e3:.1f} ms after the call on {card}", flush=True)
        step, tree = d.ckpt.restore_latest()
        if step != 2 or not torch.equal(tree["buffer"]["obs"], b.obs.cpu()):
            print("chip_checkpoint: FAILED: the restored ring is not the card's", flush=True)
            return 1
        d.close()
    print(f"chip_checkpoint: ok, the restored ring equals the card's on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
