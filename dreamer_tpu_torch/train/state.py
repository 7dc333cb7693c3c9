"""Training state (``dreamer_tpu/train/state.py:16-33``).

JAX keeps an immutable pytree; the port keeps the modules themselves and
their optimizer states, and the update writes them in place (through a
``torch.where`` that keeps the old values on a skipped step).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.nn as nn

from dreamer_tpu_torch.parallel.sharding import Block


@dataclass
class AdamState:
    """optax ``ScaleByAdamState``: first and second moments, one per
    parameter in ``module.parameters()`` order, and one int32 step count
    shared by all of them.  Under the model axis ``blocks`` names, for each
    parameter, this rank's ``parallel.sharding.Block`` of it where the axis
    shards it (else None): that parameter's moments are of the block only."""

    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: torch.Tensor
    blocks: Optional[List[Optional[Block]]] = None

    @classmethod
    def zeros_like(cls, module: nn.Module,
                   blocks: Optional[List[Optional[Block]]] = None) -> "AdamState":
        params = list(module.parameters())
        owned = params if blocks is None else [p if b is None else b.of(p)
                                               for p, b in zip(params, blocks, strict=True)]
        return cls(mu=[torch.zeros(o.shape, dtype=o.dtype, device=o.device) for o in owned],
                   nu=[torch.zeros(o.shape, dtype=o.dtype, device=o.device) for o in owned],
                   count=torch.zeros((), dtype=torch.int32, device=params[0].device),
                   blocks=blocks)


@dataclass
class ACTrainState:
    actor: nn.Module
    critic: nn.Module
    target_critic: nn.Module   # soft-updated copy of the critic
    actor_opt: AdamState
    critic_opt: AdamState
    s_scale: torch.Tensor      # () f32 return-normalisation EMA


@dataclass
class WMTrainState:
    nets: nn.Module            # the world model (``WMNets``), updated in place
    opt: AdamState


@dataclass
class DreamerState:
    wm: WMTrainState
    ac: ACTrainState
    step: torch.Tensor         # () int32 global training iteration
