"""The whole-scan GRU kernel (``csrc/gru_scan.cu``), its plain PyTorch
version and the check that holds one against the other.

Replaces ``gru_scan_forward`` (``dreamer_tpu/ops/gru_pallas.py:201-237``,
kernel ``_gru_scan_kernel`` ``:172-198``): T torch-semantics GRU steps in one
launch, h carried in float32 from step to step, with the gate residuals r, z,
n and hn of every step.  ``gru_scan`` launches the kernel for CUDA tensors
(bf16 x and weights only) and runs ``gru_scan_plain`` for CPU tensors; it
never falls back from one to the other.  ``gru_scan.launches`` counts the
kernel's launches.

On the world-model update's path the kernel runs as one step (T = 1) over
all T * B pre-step states of the posterior scan, saved by its forward: its
residuals feed the GRU's gate backward (``ops.observe_scan``).  In bf16 a
T-step launch cannot stand in for that forward, which rounds the carried
state to bf16 at every step while this kernel carries it in f32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from dreamer_tpu_torch.ops import cuda_build
from dreamer_tpu_torch.ops.gru_cuda import _round8, check_aligned, checked_plan, gate_math

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 11 + [_I] * 6 + [_P]
NAMES = ("h_seq", "r", "z", "n", "hn")

# The kernel against ``gru_scan_plain``, on each of the five f32 outputs.
# Both read the same bf16 x and weights and sum in f32 in another order: a
# gate pre-activation of 1627 products of |x| ~ 1 and |w| < 0.05 moves by
# about 1e-7, and the 30 steps of the recurrence, each a convex mix of the
# old state and a tanh, do not amplify it past 1e-5.  Held to TOL abs + TOL
# relative, a hundred times that; a dropped bias (|b| ~ 0.04 at the init)
# moves the gates by 1e-2.
TOL = 1e-3


def tolerance(ref: torch.Tensor) -> torch.Tensor:
    """The largest |kernel - plain| allowed at each element of ``ref``, one of
    the plain version's outputs."""
    return TOL + TOL * ref.float().abs()


@torch.no_grad()
def gru_scan_plain(xs, h0, wi_t, wh_t, bi, bh) -> Tuple[torch.Tensor, ...]:
    """The kernel's function step by step on the same operands: the gate math
    of ``gru_cell_plain`` in float32, h carried in float32.  Returns (h_seq,
    r, z, n, hn), each (T, B, H) float32."""
    h = h0.float()
    seqs = [[] for _ in NAMES]
    for t in range(xs.shape[0]):
        outs = gate_math(xs[t], h, wi_t, wh_t, bi, bh)
        for seq, v in zip(seqs, outs):
            seq.append(v)
        h = outs[0]
    return tuple(torch.stack(s) for s in seqs)


def _check(xs, h0, wi_t, wh_t, bi, bh) -> None:
    if xs.dim() != 3 or h0.dim() != 2 or xs.shape[1] != h0.shape[0] or xs.shape[0] < 1:
        raise ValueError(f"gru_scan: xs {tuple(xs.shape)} and h0 {tuple(h0.shape)} must be "
                         "(T, B, I) with T >= 1 and (B, H)")
    I, H = xs.shape[2], h0.shape[1]
    want = {"wi_t": (3 * H, _round8(I)), "wh_t": (3 * H, _round8(H)),
            "bi": (3 * H,), "bh": (3 * H,)}
    for name, t in zip(want, (wi_t, wh_t, bi, bh)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"gru_scan: {name} is {tuple(t.shape)}, expected {want[name]}")
    if not (xs.dtype == wi_t.dtype == wh_t.dtype):
        raise TypeError("gru_scan: xs, wi_t and wh_t must share one dtype")
    if h0.dtype != torch.float32 or bi.dtype != torch.float32 or bh.dtype != torch.float32:
        raise TypeError("gru_scan: h0 and the biases must be float32")
    tensors = (xs, h0, wi_t, wh_t, bi, bh)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("gru_scan: all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gru_scan: operands must be contiguous")


def gru_scan(xs, h0, wi_t, wh_t, bi, bh) -> Tuple[torch.Tensor, ...]:
    """T GRU steps: xs (T, B, I), h0 (B, H) float32, on the operands of
    ``gru_cuda.gru_kernel_layout``.  Returns (h_seq, r, z, n, hn), each (T,
    B, H) float32, h_seq[t] the state after step t."""
    _check(xs, h0, wi_t, wh_t, bi, bh)
    if xs.device.type == "cpu":
        return gru_scan_plain(xs, h0, wi_t, wh_t, bi, bh)
    if xs.device.type != "cuda" or xs.dtype != torch.bfloat16:
        raise TypeError(f"gru_scan: the kernel takes bfloat16 x and weights on CUDA, got "
                        f"{xs.dtype} on {xs.device}")
    T, B, I = xs.shape
    H = h0.shape[1]
    outs = tuple(torch.empty(T, B, H, dtype=torch.float32, device=xs.device) for _ in NAMES)
    if B == 0:
        return outs
    check_aligned("gru_scan", wi_t, wh_t)
    checked_plan(B, T, I, H, True)
    fn = cuda_build.kernel_fn("dt_gru_scan_forward", _ARGTYPES)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        status = fn(xs.data_ptr(), h0.data_ptr(), wi_t.data_ptr(), wh_t.data_ptr(),
                    bi.data_ptr(), bh.data_ptr(), *(o.data_ptr() for o in outs),
                    T, B, I, H, wi_t.shape[1], wh_t.shape[1], stream)
    cuda_build.check(status, "dt_gru_scan_forward")
    gru_scan.launches += 1
    return outs


gru_scan.launches = 0


def compare(out, ref) -> Dict[str, object]:
    """Hold the five outputs ``out`` to the plain version's ``ref`` (the same
    inputs) within ``tolerance``: the max error of each and ``failures``."""
    stats: Dict[str, object] = {}
    failures = []
    for name, o, r in zip(NAMES, out, ref):
        diff = (o.float() - r.float()).abs()
        stats[f"max_abs_err_{name}"] = float(diff.max()) if diff.numel() else 0.0
        if not bool(torch.isfinite(o).all()) or bool((diff > tolerance(r)).any()):
            failures.append(f"{name}: max |diff| {stats[f'max_abs_err_{name}']:.3e} over "
                            "the tolerance")
    stats["failures"] = failures
    return stats


def hold_scan(out, xs, h0, weights) -> Dict[str, object]:
    """Hold one T-step launch ``out`` (``gru_scan``'s outputs from xs, h0 and
    ``weights``) step by step: the kernel is launched again at T = 1 over all
    T * B rows, each from the launch's own pre-step state (h0, then h_seq[t -
    1]).  That launch runs the same code on the same numbers in the same
    order, so its five outputs must equal the launch's bit for bit (a fault
    in the carry across the time loop breaks this: ``carry_mismatches``
    counts the (step, row) pairs that differ); and they are held to the plain
    step on the same rows (``compare``)."""
    T, B, I = xs.shape
    h_prev = torch.cat([h0[None].float(), out[0][:-1]]).reshape(1, T * B, -1).contiguous()
    x1 = xs.reshape(1, T * B, I)
    one = gru_scan(x1, h_prev[0], *weights)
    stats = compare(one, gru_scan_plain(x1, h_prev[0], *weights))
    differ = torch.zeros(T, B, dtype=torch.bool, device=xs.device)
    for o, w in zip(one, out):
        differ |= (o.reshape(T, B, -1) != w).any(-1)
    stats["carry_mismatches"] = float(differ.sum())
    if stats["carry_mismatches"]:
        first = int(differ.any(-1).nonzero()[0, 0])
        stats["failures"].append(
            f"{int(stats['carry_mismatches'])} (step, row) pairs of the launch differ from the "
            f"same step relaunched from the launch's own states, the first at step {first}")
    return stats


def bound_numbers(T: int, B: int, I: int, H: int) -> Tuple[float, float]:
    """(bytes, bf16 operations) that one launch must move and do: x (bf16)
    and h0 (f32) read, the unpadded bf16 weights and f32 biases read once,
    the five f32 outputs written; two operations per weight per row per
    step for the x part, and twice that for the h part, whose f32 state goes
    through the tensor cores as two bf16 halves (the gate math, some 20
    operations per output, is not counted).  At T 1 x B 1500 and the
    flagship widths: 30.55 MB and 5.55 + 2 x 3.24 = 12.0 GFLOP.  (PR 6's
    kernel did the h part once on f32 inputs outside the tensor cores, and
    its bound counted it so, at the f32 rate.)"""
    nbytes = 2 * T * B * I + 4 * B * H + 2 * 3 * H * (I + H) + 4 * 6 * H + 4 * 5 * T * B * H
    return nbytes, 2.0 * T * B * 3 * H * (I + 2 * H)
