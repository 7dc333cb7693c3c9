"""The GRU-cell kernel (``csrc/gru_cell.cu``), its plain PyTorch version, the
kernel's weight layout and the launch plan it shares with the whole-scan GRU.

Replaces ``gru_cell_pallas`` (``dreamer_tpu/ops/gru_pallas.py:95-129``), forward
only.  ``gru_cell`` launches the kernel for CUDA tensors (bf16 only) and runs
``gru_cell_plain`` for CPU tensors; it never falls back from one to the other.
``gru_cell.launches`` counts the kernel's launches.

Both GRU kernels run one tensor-core core (``csrc/gru_core.cuh``) whose K
schedule (``k_schedule``) depends on the widths alone; ``gru_plan`` picks
their row tiles and column groups, and the C source's own plan
(``dt_gru_plan``) must equal it before a shape's first launch.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from dreamer_tpu_torch.ops import cuda_build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 5 + [_P]

# The kernel against ``gru_cell_plain`` in bf16.  Both sum in f32, in another
# order, and round the output (|v| < 1) to bf16 once, so an output whose sum
# lands near a rounding boundary differs by one bf16 step (2**-8 of |v| at
# most, 0.0039 at 1.0).  Held to TOL abs + TOL relative: a few steps.
TOL = 2e-2


def tolerance(ref: torch.Tensor) -> torch.Tensor:
    """The largest |kernel - plain| allowed at each element of ``ref``, the
    plain version's output."""
    return TOL + TOL * ref.float().abs()


def _round8(n: int) -> int:
    return (n + 7) // 8 * 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# k of x and of h per ring slot of the core, the most shared memory a block
# may have on an H100, the m16 tiles per warp of the many-rows plan and the
# threads of every block (gru_core.cuh).
KC_X = 128
KC_H = 64
SMEM_LIMIT = 232448
BIG_MT = 2
THREADS = 256


class GruPlan(NamedTuple):
    """A launch of the GRU core (``gru_core.cuh`` Plan, field for field)."""
    mt: int          # m16 row tiles per warp
    rw: int          # row warps per part (x part, h part); other warps only copy
    cw: int          # column warps per part, 8 hidden columns each
    stages: int      # ring slots of KC k
    bm: int          # rows per block
    j: int           # hidden columns per column group
    row_blocks: int
    col_blocks: int  # grid's second dimension (T = 1)
    col_steps: int   # column groups each block walks (T > 1)
    threads: int
    smem: int        # bytes of dynamic shared memory


def gru_plan(n: int, t: int, i: int, h: int, scan: bool = False) -> GruPlan:
    """The launch for n rows (a scan's B) over t steps at widths i, h, for
    the scan kernel or the cell: the same arithmetic as ``make_plan`` in
    ``csrc/gru_core.cuh``.  It chooses the row tiles and column groups from
    n and t and nothing else; the K schedule (``k_schedule``) is fixed.

    - t > 1: one 16-row block per row tile for all t steps, walking 32-column
      groups (8 MMA warps) through a 4-slot ring;
    - n <= 64: 16-row x 8-column blocks of 2 MMA warps and 6 copying warps
      (the weights by the TMA, a 3-slot ring), so that the weight stream
      spreads over the SMs (300 blocks at 50 rows, 3 an SM);
    - more rows: 32-row x 32-column blocks of 8 MMA warps and a 4-slot ring
      (893 blocks at 1500)."""
    if t > 1:
        mt, rw, cw = 1, 1, 4
    elif n <= 64:
        mt, rw, cw = 1, 1, 1
    else:
        mt, rw, cw = BIG_MT, 1, 4
    stages = 4 if mt == 1 and cw > 1 else 3
    bm, j = 16 * mt * rw, 8 * cw
    groups = _cdiv(h, j)
    es, gates = (4, 9) if scan else (2, 6)
    # A slot: the weight rows, then the staging chunks of the x and h rows
    # (a slot's elements from the aligned 16-byte chunk holding the first);
    # then two converted A tiles (x, h_hi and in the scan h_lo) and the
    # few-rows plan's mbarriers; the gate tile.
    few = t == 1 and n <= 64
    staged = KC_X * 2 // 16 + 1 + KC_H * es // 16 + 1
    slot = 3 * j * (KC_X + KC_H) * 2 + bm * 16 * staged
    ring = (stages * slot + 2 * bm * (KC_X + KC_H * (2 if scan else 1)) * 2
            + (64 if few else 0))
    tile = bm * (gates * j + 4) * 4
    return GruPlan(mt, rw, cw, stages, bm, j, _cdiv(n, bm), 1 if t > 1 else groups,
                   groups if t > 1 else 1, THREADS, ring + tile if t > 1 else max(ring, tile))


def k_schedule(i: int, h: int) -> Tuple[Tuple[str, int, int], ...]:
    """The order in which the core sums every output's products: (part, k0,
    k1) for each k16 chunk, x's chunks then h's, the last of each part
    reaching past the padded width into zeros.  Each part sums from zero in
    one warp, in this order; the gate math adds the parts (and the scan's
    h_lo sum, over h's chunks) in ``gru_core.cuh``'s fixed order."""
    return (tuple(("x", k, k + 16) for k in range(0, _round8(i), 16))
            + tuple(("h", k, k + 16) for k in range(0, _round8(h), 16)))


_plans: Dict[Tuple[int, int, int, int, bool], GruPlan] = {}


def checked_plan(n: int, t: int, i: int, h: int, scan: bool) -> GruPlan:
    """``gru_plan``, held once per shape against the plan the C source
    launches (``dt_gru_plan``): a kernel whose tiles drifted from the
    Python plan is refused."""
    key = (n, t, i, h, scan)
    plan = _plans.get(key)
    if plan is None:
        plan = gru_plan(n, t, i, h, scan)
        out = (ctypes.c_int * len(GruPlan._fields))()
        fn = cuda_build.kernel_fn("dt_gru_plan", [_I] * 5 + [_P])
        cuda_build.check(fn(n, t, i, h, int(scan), ctypes.addressof(out)), "dt_gru_plan")
        if tuple(out) != tuple(plan):
            raise RuntimeError(f"gru plan for n={n} t={t} i={i} h={h} scan={scan}: the C "
                               f"source launches {tuple(out)}, gru_plan says {tuple(plan)}")
        _plans[key] = plan
    return plan


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The core copies weight rows in 16-byte chunks."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: the kernel layouts must be 16-byte aligned")


def gru_kernel_layout(wi: torch.Tensor, wh: torch.Tensor, bi: torch.Tensor,
                      bh: torch.Tensor, dtype: torch.dtype
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """flax-layout GRU parameters -> the kernel's operands.

    wi (I, 3H) and wh (H, 3H), gate order r, z, n, become (3H, round8(I)) and
    (3H, round8(H)) in ``dtype``: one contiguous row per gate column, zero
    padded.  The biases are rounded to ``dtype`` (the flax cell casts them
    with the weights) and kept as float32.  Make it once per weight load."""
    def rows(w):
        k = w.shape[0]
        t = torch.zeros(w.shape[1], _round8(k), dtype=dtype, device=w.device)
        t[:, :k] = w.t().to(dtype)
        return t

    return rows(wi), rows(wh), bi.to(dtype).float(), bh.to(dtype).float()


def gate_math(x, h, wi_t, wh_t, bi, bh):
    """The GRU step in float32 on the kernel's operands: returns (out, r, z,
    n, hn), with hn = h W_hn + b_hn the hidden part of the n gate
    (``gru_pallas._gate_math``)."""
    I, H = x.shape[-1], h.shape[-1]
    hf = h.float()
    gi = x.float() @ wi_t[:, :I].float().t() + bi
    gh = hf @ wh_t[:, :H].float().t() + bh
    i_r, i_z, i_n = gi.split(H, dim=-1)
    h_r, h_z, hn = gh.split(H, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * hn)
    return (1.0 - z) * n + z * hf, r, z, n, hn


def gru_cell_plain(x, h, wi_t, wh_t, bi, bh) -> torch.Tensor:
    """Two matmuls and the gate math, in float32 on the given operands (same
    arguments and arithmetic as the kernel); returns ``x.dtype``."""
    return gate_math(x, h, wi_t, wh_t, bi, bh)[0].to(x.dtype)


def _check(x, h, wi_t, wh_t, bi, bh) -> None:
    if x.dim() != 2 or h.dim() != 2 or x.shape[0] != h.shape[0]:
        raise ValueError(f"gru_cell: x {tuple(x.shape)} and h {tuple(h.shape)} "
                         "must be (N, I) and (N, H)")
    N, I = x.shape
    H = h.shape[1]
    want = {"wi_t": (3 * H, _round8(I)), "wh_t": (3 * H, _round8(H)),
            "bi": (3 * H,), "bh": (3 * H,)}
    for name, t in zip(want, (wi_t, wh_t, bi, bh)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"gru_cell: {name} is {tuple(t.shape)}, expected {want[name]}")
    if not (x.dtype == h.dtype == wi_t.dtype == wh_t.dtype):
        raise TypeError("gru_cell: x, h, wi_t and wh_t must share one dtype")
    if bi.dtype != torch.float32 or bh.dtype != torch.float32:
        raise TypeError("gru_cell: biases must be float32")
    tensors = (x, h, wi_t, wh_t, bi, bh)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("gru_cell: all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gru_cell: operands must be contiguous")


def gru_cell(x, h, wi_t, wh_t, bi, bh) -> torch.Tensor:
    """One GRU step: x (N, I), h (N, H) -> (N, H), on the operands of
    ``gru_kernel_layout``."""
    _check(x, h, wi_t, wh_t, bi, bh)
    if x.device.type == "cpu":
        return gru_cell_plain(x, h, wi_t, wh_t, bi, bh)
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise TypeError(f"gru_cell: the kernel takes bfloat16 CUDA tensors, got "
                        f"{x.dtype} on {x.device}")
    N, I = x.shape
    H = h.shape[1]
    out = torch.empty(N, H, dtype=x.dtype, device=x.device)
    if N == 0:
        return out
    check_aligned("gru_cell", wi_t, wh_t)
    checked_plan(N, 1, I, H, False)
    fn = cuda_build.kernel_fn("dt_gru_cell_forward", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = fn(x.data_ptr(), h.data_ptr(), wi_t.data_ptr(), wh_t.data_ptr(),
                    bi.data_ptr(), bh.data_ptr(), out.data_ptr(),
                    N, I, H, wi_t.shape[1], wh_t.shape[1], stream)
    cuda_build.check(status, "dt_gru_cell_forward")
    gru_cell.launches += 1
    return out


gru_cell.launches = 0
