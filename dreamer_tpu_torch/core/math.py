"""Scalar transforms and the twohot encoding (``dreamer_tpu/core/math.py``).

``twohot`` uses the uniform bucket spacing instead of a search: one clip and
floor give the lower bucket, and the mass splits between it and the next.
"""

from __future__ import annotations

import torch


def symlog(x: torch.Tensor) -> torch.Tensor:
    """sign(x) * log(1 + |x|)."""
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x: torch.Tensor) -> torch.Tensor:
    """The inverse of ``symlog``, with the input clamped to +-20."""
    x = torch.clamp(x, -20.0, 20.0)
    return torch.sign(x) * torch.expm1(torch.abs(x))


def bucket_values(num_buckets: int, low: float = -20.0, high: float = 20.0,
                  device=None) -> torch.Tensor:
    """Uniform bucket centres ``linspace(low, high, K)`` in float32."""
    return torch.linspace(low, high, num_buckets, dtype=torch.float32, device=device)


def twohot(value: torch.Tensor, buckets: torch.Tensor) -> torch.Tensor:
    """``value`` (...,) -> (..., K): the mass split between the two buckets
    around the value clipped to the bucket range, by distance
    (``math.py:31-57``, the 1e-8 regulariser included)."""
    k = buckets.shape[0]
    lo = buckets[0]
    step = (buckets[-1] - buckets[0]) / (k - 1)
    clipped = torch.clamp(value, buckets[0], buckets[-1])
    pos = (clipped - lo) / step
    lower = torch.clamp(torch.floor(pos), 0, k - 2).long()
    lower_val = lo + lower.to(clipped.dtype) * step
    weight = (clipped - lower_val) / (step + 1e-8)
    # One-hots by comparison: a non-finite value gives an index outside
    # [0, K), which must yield a non-finite row (as in JAX), not an error.
    ids = torch.arange(k, device=value.device)
    oh_lower = (lower[..., None] == ids).float() * (1.0 - weight)[..., None].float()
    oh_upper = (lower[..., None] + 1 == ids).float() * weight[..., None].float()
    return oh_lower + oh_upper


def twohot_expectation(logits: torch.Tensor, buckets: torch.Tensor) -> torch.Tensor:
    """symexp(sum softmax(logits) * buckets), keeping a trailing singleton dim
    (``math.py:91-100``)."""
    probs = torch.softmax(logits.float(), dim=-1)
    return symexp(torch.sum(probs * buckets, dim=-1, keepdim=True))
