"""GRU cell with torch ``nn.GRUCell`` gate semantics (``dreamer_tpu/nets/gru.py``).

    r = sigmoid(W_ir x + b_ir + W_hr h + b_hr)
    z = sigmoid(W_iz x + b_iz + W_hz h + b_hz)
    n = tanh  (W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h

Parameters keep the flax names and layout: ``kernel_i`` (in, 3H), ``kernel_h``
(H, 3H), ``bias_i`` and ``bias_h`` (3H,), gate order r, z, n, initialised
U(-1/sqrt(H), 1/sqrt(H)) like torch's GRUCell.  The cell runs through
``ops.gru_cuda.gru_cell``: the CUDA kernel on the card, its plain version on
the CPU.  Unlike the flax cell, whose XLA path does its gate math in the
compute dtype, both accumulate and do the gate math in float32, as the Pallas
kernel they replace does, and round the output once.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from dreamer_tpu_torch.nets.layout import KernelLayout
from dreamer_tpu_torch.ops.gru_cuda import gru_cell, gru_cell_plain, gru_kernel_layout


def gru_cell_core(x, h, wi, wh, bi, bh) -> torch.Tensor:
    """Functional GRU step on flax-layout parameters (``gru.py:35``):
    x (B, in), h (B, H) -> (B, H), computed in float32."""
    return gru_cell_plain(x, h, wi.t(), wh.t(), bi.float(), bh.float())


class GRUCell(nn.Module):
    # The flax layout's output columns, gate order r, z, n (``parallel.sharding``).
    COLUMN_AXES = {"kernel_i": 1, "kernel_h": 1}

    def __init__(self, in_dim: int, hidden_dim: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.dtype = dtype
        bound = 1.0 / hidden_dim ** 0.5

        def uniform(*shape):
            w = torch.empty(*shape)
            return nn.Parameter(nn.init.uniform_(w, -bound, bound, generator=generator))

        # Drawn in flax's parameter order.
        self.kernel_i = uniform(in_dim, 3 * hidden_dim)
        self.kernel_h = uniform(hidden_dim, 3 * hidden_dim)
        self.bias_i = uniform(3 * hidden_dim)
        self.bias_h = uniform(3 * hidden_dim)
        self._layout = KernelLayout(lambda wi, wh, bi, bh: gru_kernel_layout(
            wi, wh, bi, bh, self.dtype))

    def kernel_weights(self):
        """The kernel's operands, made once per weight load."""
        return self._layout.get(self.kernel_i, self.kernel_h, self.bias_i, self.bias_h)

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return gru_cell(x.to(self.dtype).contiguous(), h.to(self.dtype).contiguous(),
                        *self.kernel_weights())
