"""The learner-to-actor weight wire of the host-local actor
(``runtime.rollout_device='cpu'``): the port of ``_make_broadcast_fns``
(``dreamer_tpu/orchestrator/dreamer.py:363-392``).

``flatten`` casts each learner tensor to the wire dtype
(``runtime.broadcast_dtype``) before concatenating, so the staging buffer on
the learner's device is allocated at the wire width, then brings the one
buffer to the host in one copy.  ``unflatten`` copies each slice, upcast to
float32, into the actor's parameters in place.  Under a bfloat16 wire the
actor acts on the learner's weights rounded to bfloat16 (round to nearest
even, as XLA's cast), in float32.
"""

from __future__ import annotations

from typing import Sequence

import torch


def flatten(tensors: Sequence[torch.Tensor], wire_dtype: torch.dtype) -> torch.Tensor:
    """Every tensor raveled and cast to ``wire_dtype``, concatenated on their
    device, then copied to the host: a 1-D CPU tensor."""
    flat = torch.cat([t.detach().reshape(-1).to(wire_dtype) for t in tensors])
    return flat.cpu()


def unflatten(flat: torch.Tensor, into: Sequence[torch.Tensor]) -> None:
    """Copy consecutive slices of ``flat`` into ``into``'s tensors, in order,
    each cast to its tensor's dtype."""
    n = sum(t.numel() for t in into)
    if flat.numel() != n:
        raise ValueError(f"broadcast: the wire holds {flat.numel()} values, the actor {n}")
    offset = 0
    with torch.no_grad():
        for t in into:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()
