"""Dense, LayerNorm and the LayerNorm-SiLU MLP block (``dreamer_tpu/nets/mlp.py``).

Numerics follow flax, not ``torch.nn``:

- ``Dense`` with a compute dtype casts the input, kernel and bias to it
  (flax ``promote_dtype``); parameters stay float32.
- ``LayerNorm`` takes its statistics in float32 with the fast variance
  ``max(0, E[x^2] - E[x]^2)``, eps 1e-5, then applies
  ``(x - mu) * (rsqrt(var + eps) * scale) + bias`` and casts back.

Parameters are float32, made on the CPU by flax's default initialisers
(lecun-normal kernels, zero biases, unit scales) from an explicit
``torch.Generator``; the caller moves the module to its device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

# flax's variance_scaling(1, fan_in, "truncated_normal"): the std of a unit
# normal truncated to [-2, 2] is 0.8796..., so the draw is scaled up by it.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` is (out, in), the transpose of flax's kernel."""

    # The axis of the flax kernel's output columns (``parallel.sharding``).
    COLUMN_AXES = {"weight": 0}

    def __init__(self, in_dim: int, out_dim: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, zero_init: bool = False):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        if not zero_init:
            with torch.no_grad():
                lecun_normal_(self.weight, in_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-5)`` over the last axis."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32, eps: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


def make_trunk(in_dim: int, widths: Sequence[int], dtype: torch.dtype,
               generator: Optional[torch.Generator]):
    """The ``Dense_i`` and ``LayerNorm_i`` layers of ``ln_silu_trunk``."""
    dims = [in_dim, *widths]
    denses = nn.ModuleList(Dense(dims[i], dims[i + 1], dtype, generator)
                           for i in range(len(widths)))
    norms = nn.ModuleList(LayerNorm(w, dtype) for w in widths)
    return denses, norms


def ln_silu_trunk(x: torch.Tensor, denses: Sequence[Dense],
                  norms: Sequence[LayerNorm]) -> torch.Tensor:
    """[Dense -> LayerNorm -> SiLU] per hidden layer (``mlp.py:22``)."""
    for dense, norm in zip(denses, norms):
        x = F.silu(norm(dense(x)))
    return x


class MLP(nn.Module):
    """``ln_silu_trunk`` then a plain Dense; layers ``Dense_0..len(hidden)``
    and ``LayerNorm_0..`` in flax's naming (``mlp.py:32``)."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.denses, self.norms = make_trunk(in_dim, hidden, dtype, generator)
        last = hidden[-1] if hidden else in_dim
        self.denses.append(Dense(last, out, dtype, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = ln_silu_trunk(x, self.denses[:-1], self.norms)
        return self.denses[-1](x)
