#!/usr/bin/env python3
"""Show that the kernels' checks fail faulty kernels.

    python3 chip_mutants.py [NAME ...]

Copies ``dreamer_tpu_torch`` into a temporary directory outside the checkout,
writes faulty versions of a kernel source (or of a collective of the data
axis) there, and runs the checks that ``chip_smoke.py`` holds it to on the
right version and on each faulty one.  Names pick some of the faulty copies
(default all); the right version runs the checks they need.

The GRU kernels (``csrc/gru_cell.cu`` and ``csrc/gru_scan.cu`` on the shared
core ``csrc/gru_core.cuh``), held by two checks at the flagship widths:

- ``scan``: ``gru_scan_cuda.compare`` against the plain version and
  ``gru_scan_cuda.hold_scan`` for the carry, at T 30 x B 50 and at the
  world-model path's T 1 x B 1500;
- ``cell``: the cell against ``gru_cell_plain`` within ``gru_cuda.tolerance``
  at 1, 50, 64 and 1500 rows, the 1500 rows equal to 30 launches of 50 bit
  for bit, and the scan at T = 1 on the same bf16 states equal to the cell.

Their faulty copies:

- ``carry`` (``gru_scan.cu``): every step reads h0 as its state instead of
  the last step's h';
- ``bias`` (core): the hidden bias of the n gate (b_hn) is dropped;
- ``k_tail`` (core): the last k16 chunk of x and of h (part zeros, part the
  last columns: the 3 actions of x, h's columns 592-599) is skipped;
- ``no_lo`` (core): the scan's h_lo half is zero, so its f32 state is
  rounded to bf16 in every product.

The conv encoder (``csrc/encoder.cu``), held by ``check_encoder``'s
comparison (every feature within ``conv_cuda.tolerance`` of the plain
version) at its six (frames, table) pairs, at the flagship widths with the
biases drawn:

- ``enc_kchunk``: layer 3 (the only layer whose input has 128 channels)
  loads its last weight K-chunk as zeros, dropping those products;
- ``enc_bias``: layer 2's bias (its input has 64 channels) is dropped.

The whole-rollout imagination (``csrc/imagine.cu``), held by ``imagine``:
``imagine_cuda.hold_rollout`` (a B 50 x T 30 rollout relaunched at T = 1
from its own states, bit for bit, and held to the plain step) and
``hold_steps`` (the plain rollout's 1500 states as one T = 1 launch) at the
flagship widths, at the init's nearly flat prior and at a peaked one, on
``chip_smoke.imagine_setup``'s operands:

- ``im_barrier``: the grid barrier after stage S2 (actor Dense_1) is left
  out, so S3 may read LayerNorm_1's input before every block wrote it;
- ``im_action``: the action's rows of W_i are left out of gi;
- ``im_a0_k``: actor Dense_0 loses the products of its last 128 rows of h
  (its h part's last K chunk);
- ``im_unimix``: the sampler drops the 1% unimix.

The data axis's collectives (``parallel/sharding.py``, ``train/``), held by
``update``: ``chip_smoke.run_update_check``, one learner iteration of two
ranks on the card (gloo) against one process's ``n_shards=2`` iteration
from its crafted state, and a NaN on one rank:

- ``dp_grad_mean``: each rank applies its own gradients, not their mean;
- ``dp_free_bits``: each rank clamps its own KL mean to free bits;
- ``dp_quantile``: the return scale reads this rank's returns alone;
- ``dp_nan_flag``: each rank decides the NaN skip alone.

The model axis's collectives (``parallel/sharding.py``), held by
``model_update``: ``chip_smoke.run_model_update_check``, one world-model and
one actor-critic update of ``[1, 2]`` on the card (gloo) against one
process's, from its crafted state:

- ``mp_no_gather``: the weight gather left out (a rank writes its own block
  of each sharded weight only);
- ``mp_version``: the gather written through ``.data``, which moves no
  version counter;
- ``mp_world_returns``: the returns gathered over the world, not the data
  group.

Exits non-zero unless the right kernels pass every check and each faulty one
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
# name: (source, the line to change, its faulty version, the checks to run)
MUTANTS = {
    "carry": ("gru_scan.cu", "    return t == 0 ? h0 : h_seq + (size_t)(t - 1) * N * H;\n",
              "    return h0;\n", ("scan",)),
    "bias": ("gru_core.cuh", "  b.hn = __ldg(bh + 2 * H + j);\n", "  b.hn = 0.0f;\n",
             ("scan", "cell")),
    "k_tail": ("gru_core.cuh",
               "__host__ __device__ inline int chunks16(int K) { return (K + 15) / 16; }\n",
               "__host__ __device__ inline int chunks16(int K) { return K / 16; }\n",
               ("scan", "cell")),
    "no_lo": ("gru_core.cuh",
              "    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * e] - af.x, v[2 * e + 1] - af.y);\n",
              "    const __nv_bfloat162 b = __floats2bfloat162_rn(0.0f, 0.0f);\n", ("scan", "cell")),
    "enc_kchunk": ("encoder.cu", "      const bool ok = ci < p.C && n < p.Co;\n",
                   "      const bool ok = ci < p.C && n < p.Co && !(p.Cs == 128 && kc == p.nkc - 1);\n",
                   ("encoder",)),
    "enc_bias": ("encoder.cu", "  return n < p.Co ? __ldg(p.b + n) : 0.0f;\n",
                 "  return n < p.Co && p.Cs != 64 ? __ldg(p.b + n) : 0.0f;\n", ("encoder",)),
    "im_barrier": ("imagine.cu",
                   "      if (t + 1 < d.T || st < 5) grid_sync(o.count, ++barriers * gridDim.x);\n",
                   "      if ((t + 1 < d.T || st < 5) && st != 1) grid_sync(o.count, ++barriers * gridDim.x);\n",
                   ("imagine",)),
    "im_action": ("imagine.cu",
                  "        for (int k = 0; k < tail; ++k) s = fmaf(xt[r * tail + k], c[1 + k], s);\n",
                  "        for (int k = 0; k < tail - w.A; ++k) s = fmaf(xt[r * tail + k], c[1 + k], s);\n",
                  ("imagine",)),
    "im_a0_k": ("imagine.cu",
                "      if (col < w.AH1) s = {o.a0w + (size_t)col * d.K_a0, w.H, d.H16, w.Z, w.H, o.a0b[col]};\n",
                "      if (col < w.AH1) s = {o.a0w + (size_t)col * d.K_a0, w.H - kKC, d.H16, w.Z, w.H, o.a0b[col]};\n",
                ("imagine",)),
    "im_unimix": ("imagine.cu", "    const float p = d.keep * (e / s) + d.mix;\n",
                  "    const float p = e / s;\n", ("imagine",)),
}
# The data axis's collectives: (source under dreamer_tpu_torch/, the line to
# change, its faulty version, the checks to run).
DP_MUTANTS = {
    "dp_grad_mean": ("parallel/sharding.py",
                     "            out.append((flat[i:i + g.numel()] / self.world_size).view_as(g)"
                     ".to(g.dtype))\n", "            out.append(g)\n", ("update",)),
    "dp_free_bits": ("train/world_model.py",
                     "        loss_dyn = torch.where(kl_dyn_mean >= fb, dkl_dyn, "
                     "torch.full_like(dkl_dyn, fb))\n"
                     "        loss_rep = torch.where(kl_rep_mean >= fb, dkl_rep, "
                     "torch.full_like(dkl_rep, fb))\n",
                     "        loss_dyn = torch.clamp(dkl_dyn, min=fb)\n"
                     "        loss_rep = torch.clamp(dkl_rep, min=fb)\n", ("update",)),
    "dp_quantile": ("train/agent.py", "R if plan is None else plan.gather(R)", "R", ("update",)),
    "dp_nan_flag": ("parallel/sharding.py", "        return out, flat[-1] == 0\n",
                    "        return out, finite\n", ("update",)),
}

# The model axis's collectives (``parallel/sharding.py``), held by
# ``model_update``: the same layout.
MP_MUTANTS = {
    "mp_no_gather": ("parallel/sharding.py",
                     "            self._run(\"gather_weights\", dist.all_gather_into_tensor, every, "
                     "mine,\n                      group=self.model_group)\n"
                     "            ranks = range(self.n_model)\n",
                     "            every, ranks = mine, [self.model_index]\n", ("model_update",)),
    "mp_version": ("parallel/sharding.py", "                    dst = b.of(p, k)\n",
                   "                    dst = b.of(p.data, k)\n", ("model_update",)),
    "mp_world_returns": ("parallel/sharding.py",
                         "        group, size = self.data_group, self.n_data\n",
                         "        group, size = None, self.world_size\n", ("model_update",)),
}

SCAN_CHECK = r'''
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

CELL_CHECK = r'''
import sys, torch
from dreamer_tpu_torch.nets.gru import GRUCell
from dreamer_tpu_torch.ops.gru_cuda import gru_cell, gru_cell_plain, tolerance
from dreamer_tpu_torch.ops.gru_scan_cuda import gru_scan

name, failed = sys.argv[1], 0
g = torch.Generator().manual_seed(1)
I, H = 1027, 600
ops = GRUCell(I, H, torch.bfloat16, g).cuda().kernel_weights()
for n in (1, 50, 64, 1500):
    x = torch.randn(n, I, generator=g).to("cuda", torch.bfloat16)
    h = torch.randn(n, H, generator=g).clamp(-1, 1).to("cuda", torch.bfloat16)
    out = gru_cell(x, h, *ops)
    ref = gru_cell_plain(x, h, *ops)
    err, tol = (out.float() - ref.float()).abs(), tolerance(ref)
    bad = not bool(torch.isfinite(out).all()) or bool((err > tol).any())
    line = f"mutants: {name} cell N={n}: max |kernel - plain| {float(err.max()):.3e}"
    if n == 1500:
        parts = torch.cat([gru_cell(x[i:i + 50], h[i:i + 50], *ops) for i in range(0, n, 50)])
        scan = gru_scan(x[None], h.float(), *ops)[0][0].to(torch.bfloat16)
        split, coupled = int((parts != out).sum()), int((scan != out).sum())
        bad = bad or split > 0 or coupled > 0
        line += (f"; elements differing from 30 launches of 50 rows {split}, from the scan "
                 f"at T = 1 {coupled}")
    failed += bad
    print(f"{line} -> {'FAILS' if bad else 'passes'}", flush=True)
print(f"mutants: {name} checks failed {failed}", flush=True)
'''

ENCODER_CHECK = r'''
import sys, torch
from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.nets.wm_nets import WMNets
from dreamer_tpu_torch.ops.conv_cuda import encoder_forward, encoder_forward_plain, tolerance

name, failed = sys.argv[1], 0
g = torch.Generator().manual_seed(2)
c = DreamerConfig().wm
c.obs_size, c.encoder_filters_1, c.encoder_filters_2 = (64, 64), 32, 64
nets = WMNets(c, 3, torch.bfloat16, g)
with torch.no_grad():  # the init leaves them zero; a dropped bias must show
    for conv in nets.enc_convs:
        conv.bias.copy_(0.1 * torch.randn(conv.bias.shape, generator=g))
nets = nets.cuda()
ws, bs = nets.encoder_weights()
for n, rounding in ((1, "serve"), (50, "serve"), (64, "serve"), (1250, "train"),
                    (1500, "serve"), (1500, "train")):
    table = nets.serve_norm if rounding == "serve" else nets.train_norm
    obs = torch.randint(0, 256, (n, 64, 64, 3), dtype=torch.uint8, generator=g).cuda()
    out = encoder_forward(obs, ws, bs, table).float()
    ref = encoder_forward_plain(obs, ws, bs, table).float()
    err, tol = (out - ref).abs().max(), tolerance(ref)
    bad = not bool(torch.isfinite(out).all()) or bool(err > tol)
    failed += bad
    print(f"mutants: {name} encoder N={n} ({rounding} table): max |kernel - plain| "
          f"{float(err):.3e}, tolerance {float(tol):.3e} -> {'FAILS' if bad else 'passes'}",
          flush=True)
print(f"mutants: {name} checks failed {failed}", flush=True)
'''
IMAGINE_CHECK = r'''
import sys, torch
sys.path.append(sys.argv[2])  # chip_smoke.py, after the package under test
from chip_smoke import CONFIG, PEAKED_PRIOR, imagine_setup
from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.ops import imagine_cuda as ic

name, failed = sys.argv[1], 0
cfg = DreamerConfig.from_yaml(str(CONFIG))  # the flagship: B 50 x T 30, GRU 600, 32 x 32
c, a = cfg.wm, cfg.agent
for scale in (1.0, PEAKED_PRIOR):  # the init's nearly flat prior, and a peaked one
    w, h0, z0, eps, gum = imagine_setup(cfg, scale)
    out = ic.imagine_rollout(h0, z0, eps, gum, w, c.unimix, a.min_std)
    held = ic.hold_rollout(out, eps, gum, w, c.unimix, a.min_std)
    ref = ic.imagine_rollout_plain(h0, z0, eps, gum, w, c.unimix, a.min_std)
    steps = ic.hold_steps(ref[2], ref[3], eps, gum, w, c.unimix, a.min_std)[0]
    bad = len(held["failures"]) + len(steps["failures"])
    failed += bad
    print(f"mutants: {name} imagine (prior x {scale:g}): hold_rollout carry mismatches "
          f"{int(held['carry_mismatches'])}, failures {len(held['failures'])}; hold_steps "
          f"failures {len(steps['failures'])} -> {'FAILS' if bad else 'passes'}", flush=True)
print(f"mutants: {name} checks failed {failed}", flush=True)
'''
UPDATE_CHECK = r'''
import sys
sys.path.append(sys.argv[2])  # chip_smoke.py, after the package under test
import chip_smoke

name = sys.argv[1]
failures = chip_smoke.run_update_check(chip_smoke.card_line())[2]
print(f"mutants: {name} update: {'; '.join(failures) or 'held'} -> "
      f"{'FAILS' if failures else 'passes'}", flush=True)
print(f"mutants: {name} checks failed {len(failures)}", flush=True)
'''
MODEL_UPDATE_CHECK = r'''
import sys
sys.path.append(sys.argv[2])  # chip_smoke.py, after the package under test
import chip_smoke

name = sys.argv[1]
failures = chip_smoke.run_model_update_check(chip_smoke.card_line())[2]
print(f"mutants: {name} model_update: {'; '.join(failures) or 'held'} -> "
      f"{'FAILS' if failures else 'passes'}", flush=True)
print(f"mutants: {name} checks failed {len(failures)}", flush=True)
'''
CHECKS = {"scan": SCAN_CHECK, "cell": CELL_CHECK, "encoder": ENCODER_CHECK,
          "imagine": IMAGINE_CHECK, "update": UPDATE_CHECK, "model_update": MODEL_UPDATE_CHECK}


def run(name: str, package_parent: Path, check: str) -> int:
    """The number of failed checks of one version of the kernels under
    ``package_parent`` by the check ``check``."""
    env = dict(os.environ, PYTHONPATH=str(package_parent))
    out = subprocess.run([sys.executable, "-c", CHECKS[check], name, str(ROOT)], env=env,
                         cwd=package_parent,
                         capture_output=True, text=True, timeout=600)
    sys.stdout.write(out.stdout)
    if out.returncode != 0:
        sys.stdout.write(out.stderr)
        raise RuntimeError(f"the {name} kernel's {check} check did not run")
    return int(out.stdout.strip().splitlines()[-1].split()[-1])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_mutants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout
    print(card.strip().splitlines()[0].strip(), flush=True)
    every = {**MUTANTS, **DP_MUTANTS, **MP_MUTANTS}
    names = sys.argv[1:] or list(every)
    unknown = [n for n in names if n not in every]
    if unknown:
        print(f"chip_mutants: no faulty copy named {unknown}; there are {list(every)}",
              file=sys.stderr)
        return 2
    needed = [c for c in CHECKS if any(c in every[n][3] for n in names)]
    right = {check: run(f"right ({check})", ROOT, check) for check in needed}
    failed = {"right": sum(right.values())}
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            source, good, bad, checks = every[name]
            parent = Path(tmp) / name
            shutil.copytree(ROOT / "dreamer_tpu_torch", parent / "dreamer_tpu_torch",
                            ignore=shutil.ignore_patterns("_build", "__pycache__"))
            src = parent / "dreamer_tpu_torch" / (source if name in {**DP_MUTANTS, **MP_MUTANTS}
                                                  else f"csrc/{source}")
            text = src.read_text()
            if text.count(good) != 1:
                raise RuntimeError(f"{name}: the line to change is not in {source} once")
            src.write_text(text.replace(good, bad))
            by_check = {check: run(f"{name} ({check})", parent, check) for check in checks}
            print(f"mutants: {name} failed " + ", ".join(f"{c} {v}" for c, v in by_check.items()),
                  flush=True)
            failed[name] = sum(by_check.values())
    ok = failed["right"] == 0 and all(failed[n] > 0 for n in names)
    print(f"mutants: right kernels failed {failed['right']} checks; faulty kernels failed "
          + ", ".join(f"{n} {failed[n]}" for n in names)
          + f" -> {'held' if ok else 'NOT HELD'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
