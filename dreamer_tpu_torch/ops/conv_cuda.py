"""The conv-encoder kernel (``csrc/encoder.cu``, an implicit GEMM on the
tensor cores), its launch plan, its plain PyTorch version, the kernel's
weight layout, the pixel normalisation tables and the encoder as a
differentiable function.

Replaces ``encoder_forward`` (``dreamer_tpu/ops/conv_pallas.py:110-155``).
``encoder_forward`` launches the kernel for CUDA tensors (bf16 weights only)
and runs ``encoder_forward_plain`` for CPU tensors; it never falls back from
one to the other.  ``encoder_forward.launches`` counts the wrapper's calls
that launch the kernel: each such call makes four CUDA launches of
``encoder_conv_kernel``, one per conv layer, with the tiles ``encoder_plan``
picks for the frame count (the intermediates in two scratch buffers).

``encode`` differentiates the encoder for the world-model update: its forward
is ``encoder_forward`` and its backward recomputes the plain version and
differentiates it.  That ports XLA's autodiff of the flax convs: the JAX
package has no encoder backward kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from dreamer_tpu_torch.ops import cuda_build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 13 + [_I] * 7 + [ctypes.POINTER(_I), _P]

# The kernel against ``encoder_forward_plain`` in bf16, as a share of the
# largest |feature| of the plain version.  Both sum in f32, in another order,
# and round each of the four layers to bf16, so a sum near a rounding boundary
# flips one bf16 step, which the later layers carry on, diluted, to the
# features.  2**-6 of the largest feature is two to four bf16 steps at that
# feature's scale; a dropped bias or conv tap moves the features by far more.
TOL = 2.0 ** -6


def tolerance(ref: torch.Tensor) -> torch.Tensor:
    """The largest |kernel - plain| allowed at any element of ``ref``, the
    plain version's features."""
    return TOL * ref.float().abs().max()


# The kernel's launch geometry (csrc/encoder.cu): 8 warps a block, each
# owning (MT x 16) x (NT x 8) accumulators, MT and NT in TILES; weight
# K-chunks of at most STAGE_BYTES in a ring of STAGES; a block's dynamic
# shared memory at most SMEM_LIMIT (the H100's 227 KB).
WARPS = 8
TILES = (1, 2, 4)
STAGES = 3
STAGE_BYTES = 16384
SMEM_LIMIT = 232448
_LUT_BYTES = 512


def stored_channels(c: int) -> int:
    """Channels an activation is stored with between the layers: 4 up to 4
    (layer 0's 3 padded to 4), else a multiple of 16, so that a k16 step
    reads 16 channels of one tap."""
    return 4 if c <= 4 else -(-c // 16) * 16


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One layer's launch: warp tile (mt, nt), warps along N (wn), block
    columns (bn), frames per block (g; 1 when a block takes part of one
    frame), K rows per weight stage (kc); and what follows from them: block
    rows (bm), blocks, dynamic shared memory (bytes)."""
    mt: int
    nt: int
    wn: int
    bn: int
    g: int
    kc: int
    bm: int
    blocks: int
    smem: int

    def fields(self) -> Tuple[int, ...]:
        """The eight ints ``dt_encoder_forward`` reads for this layer."""
        return (self.mt, self.nt, self.wn, self.bn, self.g, self.kc, self.blocks, self.smem)


def layer_plan(n: int, h: int, w: int, c: int, co: int, mt: int, nt: int, wn: int,
               layer: int) -> LayerPlan:
    """The launch of layer ``layer`` (0-3), (n, h, w, c) -> (n, h/2, w/2,
    co), with warp tile (mt, nt) and ``wn`` of the 8 warps along N: the same
    arithmetic as ``complete`` in ``csrc/encoder.cu``, which refuses a plan
    whose blocks or shared memory differ from it."""
    cs = stored_channels(c)
    bn, bm = wn * nt * 8, (WARPS // wn) * mt * 16
    ho, wo = h // 2, w // 2
    hwo = ho * wo
    g = max(1, bm // hwo)
    k = 16 * cs
    kc = 16
    while 2 * kc * bn * 2 <= STAGE_BYTES and k % (2 * kc) == 0:
        kc *= 2
    # The columns computed cover the stored channels (the padding is zeros).
    cso = co if layer == 3 else stored_channels(co)
    nb = -(-(-(-cso // 8) * 8) // bn)
    if g > 1:
        tr, blocks = h, nb * -(-n // g)
    else:
        ppf = -(-hwo // bm)
        tr = max(min(h, 2 * (min(hwo - 1, q * bm + bm - 1) // wo) + 3)
                 - max(0, 2 * (q * bm // wo) - 1) for q in range(ppf))
        blocks = nb * n * ppf
    # A pixel's 16-byte chunks padded to a power of two, the weight rows to
    # at least 4 chunks; a zero block as large as a pixel; layer 0 stages
    # its uint8 rows.
    ps = 1 << max(0, cs // 8 - 1).bit_length()
    rp = (w + 2) // 2 if cs == 4 else -(-(w * ps) // 8) * 8
    staging = -(-(g * tr * w * 3) // 16) * 16 if layer == 0 else 0
    region = -(-max(g * tr * rp * 16, bm * (bn + 8) * 2) // (16 * ps)) * 16 * ps
    smem = (region + min(STAGES, k // kc) * kc * max(4, bn // 8) * 16
            + max(16, ps * 16) + _LUT_BYTES + staging)
    return LayerPlan(mt, nt, wn, bn, g, kc, bm, blocks, smem)


# Registers a thread of each instantiation uses (the build's ptxas report).
_REGISTERS = {(4, 4): 128, (4, 2): 96, (2, 4): 80}


def _estimate_us(plan: LayerPlan, k: int, sms: int) -> float:
    """A rough model of a launch's time, to rank plans.  The blocks an SM
    runs each take their MMAs (4 TFLOP/s per SM), loads (150 GB/s per SM)
    and epilogue, at full rate only with 16 warps resident to hide latency;
    blocks with little work take the waves of their chains of dependent k16
    steps (about 40 cycles each)."""
    regs = _REGISTERS.get((plan.mt, plan.nt), 64)
    occ = max(1, min(65536 // (regs * 256), 233472 // (plan.smem + 1024), 8))
    act = plan.smem - min(STAGES, k // plan.kc) * plan.kc * max(4, plan.bn // 8) * 16
    t_block = (2 * plan.bm * plan.bn * k / 4e6 + (act + k * plan.bn * 2) / 1.5e5
               + plan.bm * plan.bn / 1.4e4)
    per_sm = -(-plan.blocks // sms)
    eff = min(1.0, min(occ, per_sm) / 2)
    return max(per_sm * t_block / eff, -(-plan.blocks // (sms * occ)) * (k // 16) * 0.025)


@functools.lru_cache(maxsize=64)
def encoder_plan(n: int, h: int, w: int, chans: Tuple[int, ...], sms: int = 132
                 ) -> Tuple[LayerPlan, ...]:
    """The four layers' launches for ``n`` frames of h x w x 3 and widths
    ``chans`` (c1..c4) on a card with ``sms`` SMs: for each layer, of the warp
    tiles that fit in shared memory, the one ``_estimate_us`` ranks fastest
    (ties to fewer blocks).  Many frames get large tiles, each weight chunk
    serving up to 512 rows; few frames get small ones spread over more SMs."""
    plans = []
    cin = 3
    for l, co in enumerate(chans):
        hl, wl = h >> l, w >> l
        k = 16 * stored_channels(cin)
        nc = -(-(co if l == 3 else stored_channels(co)) // 8) * 8
        best = None
        for mt in TILES:
            for nt in TILES:
                for wn in (1, 2, 4, 8):
                    if wn * nt * 8 > max(8, 1 << (nc - 1).bit_length()):
                        continue
                    plan = layer_plan(n, hl, wl, cin, co, mt, nt, wn, l)
                    if plan.smem > SMEM_LIMIT:
                        continue
                    key = (_estimate_us(plan, k, sms), plan.blocks, -plan.bm * plan.bn)
                    if best is None or key < best[0]:
                        best = (key, plan)
        if best is None:
            raise ValueError(f"encoder_forward: no tile of layer {l} fits in shared memory "
                             f"for {hl}x{wl}x{cin} frames")
        plans.append(best[1])
        cin = co
    return tuple(plans)


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def encoder_kernel_layout(weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor],
                          dtype: torch.dtype) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """OIHW conv weights -> the kernel's contiguous HWIO ``dtype`` copies (the
    flax layout), biases -> float32.  Make it once per weight load."""
    return ([w.permute(2, 3, 1, 0).contiguous().to(dtype) for w in weights],
            [b.float().contiguous() for b in biases])


def norm_table(rounding: str, dtype: torch.dtype) -> torch.Tensor:
    """The value each uint8 pixel u normalises to, (256,) in ``dtype``.

    - ``"serve"``: u / 255 - 0.5 in float32, rounded to ``dtype`` once, as the
      JAX policy programs (``train/step.py:198, 213, 233``) and the Pallas
      encoder (``conv_pallas.py:101-102``) compute it;
    - ``"train"``: u / 255 rounded to ``dtype``, then minus 0.5 rounded again:
      ``obs_u8.astype(dtype) / 255.0 - 0.5`` in the compute dtype, as the JAX
      losses compute it (``train/world_model.py:169``, ``train/agent.py:129``).

    In float32 the two are equal."""
    u = torch.arange(256, dtype=torch.float32)
    if rounding == "serve":
        return (u / 255.0 - 0.5).to(dtype)
    if rounding == "train":
        return ((u / 255.0).to(dtype).float() - 0.5).to(dtype)
    raise ValueError(f"norm_table: rounding {rounding!r} is neither 'serve' nor 'train'")


def encoder_forward_plain(obs_u8: torch.Tensor, weights: Sequence[torch.Tensor],
                          biases: Sequence[torch.Tensor], table: torch.Tensor) -> torch.Tensor:
    """The frames through ``table`` (``norm_table``), then four
    ``conv2d(stride=2, padding=1)`` + SiLU in float32 on the given operands,
    each layer's output rounded to the weights' dtype as the kernel does; the
    features come back in (h, w, c) flatten order."""
    dtype = weights[0].dtype
    x = table[obs_u8.long()].permute(0, 3, 1, 2)
    for w, b in zip(weights, biases):
        y = F.conv2d(x.float(), w.float().permute(3, 2, 0, 1), b, stride=2, padding=1)
        x = F.silu(y).to(dtype)
    # NCHW -> NHWC before flattening, so that the features line up with the
    # posterior head's (h, w, c)-ordered weight rows.
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _check(obs_u8, weights, biases, table) -> None:
    if obs_u8.dim() != 4 or obs_u8.shape[-1] != 3 or obs_u8.dtype != torch.uint8:
        raise ValueError(f"encoder_forward: obs must be (N, H, W, 3) uint8, got "
                         f"{tuple(obs_u8.shape)} {obs_u8.dtype}")
    H, W = obs_u8.shape[1:3]
    if H % 16 or W % 16:
        raise ValueError(f"encoder_forward: frame {H}x{W} is not a multiple of 16")
    if len(weights) != 4 or len(biases) != 4:
        raise ValueError("encoder_forward: expects four conv layers")
    cin = 3
    for l, (w, b) in enumerate(zip(weights, biases)):
        if w.dim() != 4 or tuple(w.shape[:3]) != (4, 4, cin) or tuple(b.shape) != (w.shape[3],):
            raise ValueError(f"encoder_forward: layer {l} weight {tuple(w.shape)} / bias "
                             f"{tuple(b.shape)} do not match (4, 4, {cin}, C) / (C,)")
        if w.dtype != weights[0].dtype or b.dtype != torch.float32:
            raise TypeError("encoder_forward: weights must share one dtype; biases float32")
        cin = w.shape[3]
    if tuple(table.shape) != (256,) or table.dtype != weights[0].dtype:
        raise ValueError(f"encoder_forward: the table is {tuple(table.shape)} {table.dtype}, "
                         f"expected (256,) {weights[0].dtype}")
    tensors = (obs_u8, table, *weights, *biases)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("encoder_forward: all operands must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("encoder_forward: operands must be contiguous")


def encoder_forward(obs_u8: torch.Tensor, weights: Sequence[torch.Tensor],
                    biases: Sequence[torch.Tensor], table: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 frames -> (N, H/16 * W/16 * C4) features in the
    weights' dtype; weights HWIO (4, 4, C_l, C_l+1), biases float32, the
    frames normalised through ``table`` (``norm_table``, in the weights'
    dtype)."""
    _check(obs_u8, weights, biases, table)
    if obs_u8.device.type == "cpu":
        return encoder_forward_plain(obs_u8, weights, biases, table)
    if obs_u8.device.type != "cuda" or weights[0].dtype != torch.bfloat16:
        raise TypeError(f"encoder_forward: the kernel takes bfloat16 weights on CUDA, "
                        f"got {weights[0].dtype} on {obs_u8.device}")
    N, H, W, _ = obs_u8.shape
    chans = [w.shape[3] for w in weights]
    out = torch.empty(N, (H // 16) * (W // 16) * chans[-1], dtype=torch.bfloat16,
                      device=obs_u8.device)
    if N == 0:
        return out
    fn = cuda_build.kernel_fn("dt_encoder_forward", _ARGTYPES)
    dev = obs_u8.device
    plan = encoder_plan(N, H, W, tuple(chans), _sm_count(dev.index or 0))
    fields = [f for p in plan for f in p.fields()]
    # Layers 0 and 2 write buf_a, layer 1 buf_b, channels as stored_channels.
    sizes = [N * (H >> l + 1) * (W >> l + 1) * stored_channels(c) for l, c in enumerate(chans)]
    buf_a = torch.empty(max(sizes[0], sizes[2]), dtype=torch.bfloat16, device=dev)
    buf_b = torch.empty(sizes[1], dtype=torch.bfloat16, device=dev)
    wb = [t.data_ptr() for pair in zip(weights, biases) for t in pair]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(obs_u8.data_ptr(), table.data_ptr(), *wb, out.data_ptr(), buf_a.data_ptr(),
                    buf_b.data_ptr(), N, H, W, *chans, (_I * len(fields))(*fields), stream)
    cuda_build.check(status, "dt_encoder_forward")
    encoder_forward.launches += 1
    return out


encoder_forward.launches = 0


class _Encode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, obs_u8, table, operands, *params):
        ws, bs = operands
        ctx.dtype = ws[0].dtype
        ctx.save_for_backward(obs_u8, table, *params)
        return encoder_forward(obs_u8, ws, bs, table)

    @staticmethod
    def backward(ctx, d_out):
        obs_u8, table, *params = ctx.saved_tensors
        with torch.enable_grad():
            params = [p.detach().requires_grad_() for p in params]
            ws, bs = encoder_kernel_layout(params[0::2], params[1::2], ctx.dtype)
            out = encoder_forward_plain(obs_u8, ws, bs, table)
            grads = torch.autograd.grad(out, params, d_out)
        return (None, None, None, *grads)


def encode(obs_u8: torch.Tensor, table: torch.Tensor, operands, params: Sequence[torch.Tensor]
           ) -> torch.Tensor:
    """``encoder_forward(obs_u8, *operands, table)``, differentiable in
    ``params``, the OIHW weights and biases interleaved (w0, b0, ..., w3, b3)
    from which ``operands`` = ``encoder_kernel_layout(...)`` were made."""
    return _Encode.apply(obs_u8, table, operands, *params)
