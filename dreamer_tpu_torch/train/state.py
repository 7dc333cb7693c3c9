"""Training state (``dreamer_tpu/train/state.py:16-33``).

JAX keeps an immutable pytree; the port keeps the modules themselves and
their optimizer states, and the update writes them in place (through a
``torch.where`` that keeps the old values on a skipped step).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch
import torch.nn as nn


@dataclass
class AdamState:
    """optax ``ScaleByAdamState``: first and second moments, one per
    parameter in ``module.parameters()`` order, and one int32 step count
    shared by all of them."""

    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: torch.Tensor

    @classmethod
    def zeros_like(cls, module: nn.Module) -> "AdamState":
        params = list(module.parameters())
        return cls(mu=[torch.zeros_like(p) for p in params],
                   nu=[torch.zeros_like(p) for p in params],
                   count=torch.zeros((), dtype=torch.int32, device=params[0].device))


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
