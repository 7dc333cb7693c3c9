"""The fused conv-encoder kernel (``csrc/encoder.cu``), its plain PyTorch
version, the kernel's weight layout, the pixel normalisation tables and the
encoder as a differentiable function.

Replaces ``encoder_forward`` (``dreamer_tpu/ops/conv_pallas.py:110-155``).
``encoder_forward`` launches the kernel for CUDA tensors (bf16 weights only)
and runs ``encoder_forward_plain`` for CPU tensors; it never falls back from
one to the other.  ``encoder_forward.launches`` counts the kernel's launches.

``encode`` differentiates the encoder for the world-model update: its forward
is ``encoder_forward`` and its backward recomputes the plain version and
differentiates it.  That ports XLA's autodiff of the flax convs: the JAX
package has no encoder backward kernel.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from dreamer_tpu_torch.ops import cuda_build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 11 + [_I] * 7 + [_P]

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
    wb = [t.data_ptr() for pair in zip(weights, biases) for t in pair]
    with torch.cuda.device(obs_u8.device):
        stream = torch.cuda.current_stream(obs_u8.device).cuda_stream
        status = fn(obs_u8.data_ptr(), table.data_ptr(), *wb, out.data_ptr(), N, H, W, *chans,
                    stream)
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
