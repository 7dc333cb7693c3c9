"""``runtime.debug_nans``: stop at the first non-finite value of an update
or a policy step, naming it, before the update's NaN skip can swallow it.

The port of ``jax_debug_nans`` (``dreamer_tpu/cli/train.py:54-55``), which
re-runs a program op by op and raises ``FloatingPointError`` at the first
NaN.  Here each update checks, in order, its loss terms, the gradient of
every parameter and the parameters the step would write; the policy checks
its state and action.  Each check is one host read; with the flag off none
is made.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch


def check_finite(where: str, named: Iterable[Tuple[str, Optional[torch.Tensor]]]) -> None:
    """Raise ``FloatingPointError`` naming ``where`` and the first tensor of
    ``named`` (name, tensor) that holds a NaN or an infinity."""
    named = [(n, t) for n, t in named if t is not None]
    if not named:
        return
    finite = torch.stack([torch.isfinite(t.detach()).all() for _, t in named]).cpu()
    if not bool(finite.all()):
        name = named[int((~finite).nonzero()[0])][0]
        raise FloatingPointError(f"debug_nans: the {where} holds a non-finite value in {name}")
