"""Lambda-returns and the percentile return-scale EMA
(``dreamer_tpu/core/returns.py:16-61``)."""

from __future__ import annotations

import torch


def lambda_returns(values: torch.Tensor, rewards: torch.Tensor, continues: torch.Tensor,
                   gamma: float, lambda_: float) -> torch.Tensor:
    """R_lambda (B, T) from values (B, T+1) of states 0..T, rewards and
    continues (B, T) of the transitions t -> t+1:

        R_{T-1} = r_{T-1} + gamma * c_{T-1} * V_T
        R_t     = r_t + gamma * c_t * ((1 - lambda) * V_{t+1} + lambda * R_{t+1})
    """
    T = rewards.shape[1]
    ret = rewards[:, -1] + gamma * continues[:, -1] * values[:, -1]
    out = [ret]
    for t in range(T - 2, -1, -1):
        ret = rewards[:, t] + gamma * continues[:, t] * (
            (1.0 - lambda_) * values[:, t + 1] + lambda_ * ret)
        out.append(ret)
    return torch.stack(out[::-1], dim=1)


def update_return_scale(s: torch.Tensor, returns: torch.Tensor,
                        smoothing: float = 0.99) -> torch.Tensor:
    """EMA of max(P95 - P05, 1) over the flattened returns; ``s`` is kept
    where a return is not finite.  No host sync: the guard is a
    ``torch.where``.  ``torch.quantile``'s default ``linear`` interpolation is
    ``jnp.quantile``'s."""
    flat = returns.detach().reshape(-1).float()
    finite = torch.isfinite(flat).all()
    q = torch.quantile(flat, torch.tensor([0.95, 0.05], device=flat.device))
    rng = torch.clamp(q[0] - q[1], min=1.0)
    alpha = 1.0 - smoothing
    return torch.where(finite, (1.0 - alpha) * s + alpha * rng, s)
