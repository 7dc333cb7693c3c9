"""Distribution primitives (``dreamer_tpu/core/dists.py``).

Every sampler takes its noise as a tensor instead of a key: gumbel noise for
the categorical latents, standard-normal ``eps`` for the action.  The serving
path draws it from the caller's ``torch.Generator``; tests pass the noise that
JAX draws from its keys, which reproduces JAX's samples exactly, because
``jax.random.categorical(k, logp) == argmax(logp + jax.random.gumbel(k, ...))``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

_LOG_SIG_MIN = -5.0
_LOG_SIG_MAX = 2.0
_SIG_FLOOR = 1e-3
_ACTION_EPS = 1e-6


def unimix_probs(logits: torch.Tensor, unimix: float = 0.01) -> torch.Tensor:
    """Softmax mixed with ``unimix`` uniform, in float32 (``dists.py:23``)."""
    probs = torch.softmax(logits.float(), dim=-1)
    return (1.0 - unimix) * probs + unimix / logits.shape[-1]


def sample_onehot_ste(probs: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """Straight-through one-hot sample ``onehot + probs - sg(probs)``
    (``dists.py:34``), with the category ``argmax(log probs + gumbel)``.

    The sum is kept as JAX computes it: in float32 ``1 + p - p`` is not always
    exactly 1, and the GRU reads that value."""
    idx = torch.argmax(torch.log(probs) + gumbel, dim=-1)
    onehot = F.one_hot(idx, probs.shape[-1]).to(probs.dtype)
    return onehot + probs - probs.detach()


def categorical_kl(logits_p: torch.Tensor, logits_q: torch.Tensor) -> torch.Tensor:
    """KL(P || Q) over the last axis from raw logits, in float32
    (``dists.py:46-55``): on the logits themselves, not on the unimixed
    probabilities."""
    lp = F.log_softmax(logits_p.float(), dim=-1)
    lq = F.log_softmax(logits_q.float(), dim=-1)
    return torch.sum(torch.exp(lp) * (lp - lq), dim=-1)


def sample_gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard gumbel noise ``-log(-log(u))`` with u in (0, 1), float32."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp_(min=tiny)
    return -torch.log(-torch.log(u))


def actor_mu_sigma(mu_raw: torch.Tensor, log_sig_raw: torch.Tensor,
                   min_std: float = _SIG_FLOOR) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mu, softplus(clip(log_sig, -5, 2)) + min_std) (``dists.py:68``)."""
    log_sig = torch.clamp(log_sig_raw, _LOG_SIG_MIN, _LOG_SIG_MAX)
    return mu_raw, F.softplus(log_sig) + min_std


def tanh_normal_logprob(action: torch.Tensor, mu: torch.Tensor,
                        sigma: torch.Tensor) -> torch.Tensor:
    """log pi(action) of the tanh-squashed Normal, summed over the action
    dim, with the action clamped to +-(1 - 1e-6) and torch's stable
    log|det J| = 2 (log 2 - x - softplus(-2x)), x = atanh(action)
    (``dists.py:97-113``)."""
    a = torch.clamp(action, -1.0 + _ACTION_EPS, 1.0 - _ACTION_EPS)
    x = torch.atanh(a)
    base = -0.5 * torch.square((x - mu) / sigma) - torch.log(sigma) \
        - 0.5 * math.log(2.0 * math.pi)
    log_det = 2.0 * (math.log(2.0) - x - F.softplus(-2.0 * x))
    return torch.sum(base - log_det, dim=-1)


def normal_entropy(sigma: torch.Tensor) -> torch.Tensor:
    """Analytic entropy of the unsquashed diagonal Normal, summed over the
    action dim (``dists.py:116-129``)."""
    return torch.sum(0.5 * math.log(2.0 * math.pi * math.e) + torch.log(sigma), dim=-1)
