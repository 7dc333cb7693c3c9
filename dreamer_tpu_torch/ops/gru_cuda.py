"""The GRU-cell kernel (``csrc/gru_cell.cu``), its plain PyTorch version and
the kernel's weight layout.

Replaces ``gru_cell_pallas`` (``dreamer_tpu/ops/gru_pallas.py:95-129``), forward
only.  ``gru_cell`` launches the kernel for CUDA tensors (bf16 only) and runs
``gru_cell_plain`` for CPU tensors; it never falls back from one to the other.
``gru_cell.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

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
