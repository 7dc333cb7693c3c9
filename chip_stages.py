#!/usr/bin/env python3
"""Where a step of the imagination kernel spends its time, stage by stage.

    python3 chip_stages.py

Copies ``dreamer_tpu_torch`` into a temporary directory outside the checkout,
adds to ``csrc/imagine.cu`` there a %globaltimer stamp on thread 0 of every
block at the start of step 5, before each of its six grid barriers and after
each, builds that copy and launches it at the flagship widths (B 50 x T 30,
and over 66 blocks), the drone's (B 128 x T 30) and the tests' small widths.
For each stage it prints the blocks' median and largest time from the last
barrier to their arrival at the next one (the work, "comp"), the time from
the last block leaving the previous barrier to the last leaving this one
("wall") and that barrier's share of it (last departure minus last arrival,
"bar"); each launch's mean time over 20 launches by CUDA events beside them.
The stamps cost a few hundred nanoseconds a step.  Needs a CUDA device and
nvcc; the checkout is not modified.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
STEP = 5
STAMPS = r'''
__device__ unsigned long long g_stamp[1024 * 16];
extern "C" int dt_stamps(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));
}
#define STAMP(i) if (t == STEP && threadIdx.x == 0) { unsigned long long v; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v)); g_stamp[blockIdx.x * 16 + (i)] = v; }
'''
LOOP = "      if (t + 1 < d.T || st < 5) grid_sync(o.count, ++barriers * gridDim.x);\n"
RUN = r'''
import ctypes, statistics, sys, torch
sys.path.append(sys.argv[1])  # chip_smoke.py, after the patched package
from chip_smoke import CONFIG, DRONE, imagine_setup
from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.ops import cuda_build, imagine_cuda as ic

def setup(path, small=False):
    cfg = DreamerConfig.from_yaml(str(path))
    c, a = cfg.wm, cfg.agent
    if small:  # the tests' widths, at the flagship's B 50 x T 30
        c.hidden_dim, c.latent_rows, c.latent_classes = 64, 8, 16
        c.dyn_hidden_1 = c.dyn_hidden_2 = a.actor_hidden_1 = a.actor_hidden_2 = 24
    w, h0, z0, eps, gum = imagine_setup(cfg)
    return h0, z0, eps, gum, w, c.unimix, a.min_std

for name, args, blocks in (("flagship", setup(CONFIG), None), ("flagship", setup(CONFIG), 66),
                           ("drone", setup(DRONE), None), ("small", setup(CONFIG, True), None)):
    nb = blocks or ic.sm_count(args[0].device)
    run = lambda: ic._launch(*args, nb)  # noqa: E731
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        run()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / 20
    run()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (1024 * 16))()
    cuda_build.check(cuda_build.library().dt_stamps(buf), "dt_stamps")
    st = [[buf[b * 16 + i] for i in range(13)] for b in range(nb)]
    parts, prev = [], [st[b][0] for b in range(nb)]
    for s in range(6):
        arr = [st[b][1 + 2 * s] for b in range(nb)]
        dep = [st[b][2 + 2 * s] for b in range(nb)]
        comp = [x - y for x, y in zip(arr, prev)]
        parts.append(f"S{s + 1} comp med {statistics.median(comp) / 1e3:.2f} max "
                     f"{max(comp) / 1e3:.2f} wall {(max(dep) - max(prev)) / 1e3:.2f} "
                     f"(bar {(max(dep) - max(arr)) / 1e3:.2f})")
        prev = dep
    print(f"stages: {name} B={args[0].shape[0]} T={args[2].shape[0]} over {nb} blocks: "
          f"kernel_ms {ms:.4f}; step {STEP} in us: " + "; ".join(parts)
          + f"; step total {(max(prev) - max(st[b][0] for b in range(nb))) / 1e3:.2f}",
          flush=True)
'''


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_stages: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout
    print(card.strip().splitlines()[0].strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(ROOT / "dreamer_tpu_torch", Path(tmp) / "dreamer_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        src = Path(tmp) / "dreamer_tpu_torch" / "csrc" / "imagine.cu"
        text = src.read_text()
        loop = "    for (int st = 0; st < 6; ++st) {\n"
        if text.count(LOOP) != 1 or text.count(loop) != 1:
            raise RuntimeError("imagine.cu's stage loop is not where chip_stages.py expects it")
        text = text.replace('#include "gru_core.cuh"\n',
                            '#include "gru_core.cuh"\n' + STAMPS.replace("STEP", str(STEP)), 1)
        text = text.replace(loop, loop + "      if (st == 0) STAMP(0)\n")
        text = text.replace(LOOP, "      STAMP(1 + 2 * st)\n" + LOOP + "      STAMP(2 + 2 * st)\n")
        src.write_text(text)
        env = dict(os.environ, PYTHONPATH=tmp)
        out = subprocess.run([sys.executable, "-c", RUN.replace("STEP", str(STEP)), str(ROOT)],
                             env=env, cwd=tmp, capture_output=True, text=True, timeout=900)
        sys.stdout.write(out.stdout)
        if out.returncode != 0:
            sys.stdout.write(out.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
