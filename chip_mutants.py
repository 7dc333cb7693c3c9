#!/usr/bin/env python3
"""Show that the whole-scan GRU kernel's checks fail faulty kernels.

    python3 chip_mutants.py

Copies ``dreamer_tpu_torch`` into a temporary directory outside the checkout,
writes two faulty versions of ``csrc/gru_scan.cu`` there, and runs the same
checks that ``chip_smoke.py`` holds the kernel to (``gru_scan_cuda.compare``
against the plain version, ``gru_scan_cuda.hold_scan`` for the carry) on the
right kernel and on each faulty one, at the flagship T 30 x B 50 and at the
world-model path's T 1 x B 1500:

- ``carry``: h' is never written to the next step's state, so every step
  after the first starts from zero;
- ``bias``: the hidden bias of the n gate (b_hn) is dropped.

Exits non-zero unless the right kernel passes every check and each faulty one
fails at least one.  Needs a CUDA device and nvcc; the checkout is not
modified.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MUTANTS = {
    "carry": ("          h_next[r * Hp + j] = out;\n", "          (void)out;\n"),
    "bias": ("  const float b_hn = bh[2 * H + j];\n", "  const float b_hn = 0.0f;\n"),
}

CHECK = r'''
import sys, torch
from dreamer_tpu_torch.nets.gru import GRUCell
from dreamer_tpu_torch.ops import gru_scan_cuda as gs

name, failed = sys.argv[1], 0
g = torch.Generator().manual_seed(11)
I, H = 1027, 600
ops = GRUCell(I, H, torch.bfloat16, g).cuda().kernel_weights()
for T, B in ((30, 50), (1, 1500)):
    xs = torch.randn(T, B, I, generator=g).to("cuda", torch.bfloat16)
    h0 = torch.randn(B, H, generator=g).clamp(-1, 1).to(torch.bfloat16).float().cuda()
    out = gs.gru_scan(xs, h0, *ops)
    cmp = gs.compare(out, gs.gru_scan_plain(xs, h0, *ops))
    failed += len(cmp["failures"])
    line = (f"mutants: {name} T={T} B={B}: max |kernel - plain| h_seq "
            f"{cmp['max_abs_err_h_seq']:.3e} hn {cmp['max_abs_err_hn']:.3e}, "
            f"compare failures {len(cmp['failures'])}")
    if T > 1:
        held = gs.hold_scan(out, xs, h0, ops)
        failed += len(held["failures"])
        line += (f"; hold_scan carry mismatches {int(held['carry_mismatches'])}, "
                 f"failures {len(held['failures'])}")
    print(line, flush=True)
print(f"mutants: {name} checks failed {failed}", flush=True)
'''


def run(name: str, package_parent: Path) -> int:
    """The number of failed checks of one kernel version."""
    env = dict(os.environ, PYTHONPATH=str(package_parent))
    out = subprocess.run([sys.executable, "-c", CHECK, name], env=env, cwd=package_parent,
                         capture_output=True, text=True, timeout=600)
    sys.stdout.write(out.stdout)
    if out.returncode != 0:
        sys.stdout.write(out.stderr)
        raise RuntimeError(f"the {name} kernel's check did not run")
    return int(out.stdout.strip().splitlines()[-1].split()[-1])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_mutants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout
    print(card.strip().splitlines()[0].strip(), flush=True)
    failed = {"right": run("right", ROOT)}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (good, bad) in MUTANTS.items():
            parent = Path(tmp) / name
            shutil.copytree(ROOT / "dreamer_tpu_torch", parent / "dreamer_tpu_torch",
                            ignore=shutil.ignore_patterns("_build", "__pycache__"))
            src = parent / "dreamer_tpu_torch" / "csrc" / "gru_scan.cu"
            text = src.read_text()
            if text.count(good) != 1:
                raise RuntimeError(f"{name}: the line to change is not in gru_scan.cu once")
            src.write_text(text.replace(good, bad))
            failed[name] = run(name, parent)
    ok = failed["right"] == 0 and all(failed[n] > 0 for n in MUTANTS)
    print(f"mutants: right kernel failed {failed['right']} checks; faulty kernels failed "
          + ", ".join(f"{n} {failed[n]}" for n in MUTANTS)
          + f" -> {'held' if ok else 'NOT HELD'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
