"""The port's core math, returns and distributions against the JAX package,
on inputs made with numpy, in float32.

Tolerance: 1e-6 abs + 1e-5 rel.  Both sides compute in float32 elementwise
or in short sums, in another order at most (measured: a few ulp); the
twohot weights and the quantiles are exact to that.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamer_tpu.core import dists as jdists
from dreamer_tpu.core import math as jmath
from dreamer_tpu.core import returns as jreturns
from dreamer_tpu_torch.core import dists, math, returns

RTOL, ATOL = 1e-5, 1e-6


def close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.fixture
def values():
    rng = np.random.default_rng(0)
    v = np.concatenate([rng.standard_normal(200) * 30.0, [0.0, -20.0, 20.0, 25.0, -1e4, 1e-7]])
    return v.astype(np.float32)


@pytest.mark.parametrize("fn", ["symlog", "symexp"])
def test_symlog_symexp(values, fn):
    close(getattr(math, fn)(torch.from_numpy(values)), getattr(jmath, fn)(jnp.asarray(values)))


@pytest.mark.parametrize("k", [31, 255])
def test_twohot_and_its_expectation(values, k):
    port_b, jax_b = math.bucket_values(k), jmath.bucket_values(k)
    close(port_b, jax_b)
    close(math.twohot(torch.from_numpy(values), port_b), jmath.twohot(jnp.asarray(values), jax_b))
    logits = np.random.default_rng(1).standard_normal((6, 5, k)).astype(np.float32) * 3
    close(math.twohot_expectation(torch.from_numpy(logits), port_b),
          jmath.twohot_expectation(jnp.asarray(logits), jax_b))


def test_lambda_returns():
    rng = np.random.default_rng(2)
    B, T = 5, 9
    v = rng.standard_normal((B, T + 1)).astype(np.float32)
    r = rng.standard_normal((B, T)).astype(np.float32)
    c = rng.uniform(0, 1, (B, T)).astype(np.float32)
    close(returns.lambda_returns(*map(torch.from_numpy, (v, r, c)), 0.99, 0.95),
          jreturns.lambda_returns(*map(jnp.asarray, (v, r, c)), 0.99, 0.95))


@pytest.mark.parametrize("case", ["wide", "narrow", "nan", "inf"])
def test_update_return_scale(case):
    rng = np.random.default_rng(3)
    R = (rng.standard_normal((7, 11)) * (10.0 if case == "wide" else 0.1)).astype(np.float32)
    if case == "nan":
        R[2, 3] = np.nan
    if case == "inf":
        R[0, 0] = np.inf
    s = np.float32(1.7)
    port = returns.update_return_scale(torch.tensor(s), torch.from_numpy(R), 0.99)
    ref = jreturns.update_return_scale(jnp.asarray(s), jnp.asarray(R), 0.99)
    close(port, ref)
    if case in ("nan", "inf"):
        assert float(port) == float(s)


def test_tanh_normal_logprob_and_entropy():
    rng = np.random.default_rng(4)
    a = np.tanh(rng.standard_normal((6, 4, 3)) * 2).astype(np.float32)
    a[0, 0] = [1.0, -1.0, 0.0]  # clamped to +-(1 - 1e-6)
    mu = rng.standard_normal((6, 4, 3)).astype(np.float32)
    sigma = rng.uniform(0.05, 2.0, (6, 4, 3)).astype(np.float32)
    close(dists.tanh_normal_logprob(*map(torch.from_numpy, (a, mu, sigma))),
          jdists.tanh_normal_logprob(*map(jnp.asarray, (a, mu, sigma))))
    close(dists.normal_entropy(torch.from_numpy(sigma)), jdists.normal_entropy(jnp.asarray(sigma)))
