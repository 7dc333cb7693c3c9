"""The whole-scan GRU's plain version (``ops.gru_scan_cuda.gru_scan_plain``)
against the JAX package's ``gru_scan_forward`` (the Pallas kernel in
interpret mode, as tests/test_pallas.py runs it) at T 5, B 10, I 37, H 29 in
float32, from the same inputs made with numpy: h_seq and the four residuals
to 1e-5 abs/rel (float32 sums in another order; measured under 1e-6).

Then the two properties the world-model path and the card's check rest on:
the T = 1 launch over all T * B pre-step states gives the T-step residuals
(float32, to 1e-6: the same arithmetic on other matmul batch sizes), and
``hold_scan`` fails a launch whose carried state is one float32 step off.
The card's own tests are in tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dreamer_tpu.ops.gru_pallas import gru_scan_forward
from dreamer_tpu_torch.ops import gru_scan_cuda
from dreamer_tpu_torch.ops.gru_cuda import gru_kernel_layout
from dreamer_tpu_torch.ops.gru_scan_cuda import NAMES, gru_scan, gru_scan_plain, hold_scan

T, B, I, H = 5, 10, 37, 29
TOL = 1e-5


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(H)
    xs = rng.standard_normal((T, B, I)).astype(np.float32)
    h0 = rng.standard_normal((B, H)).astype(np.float32)
    wi, wh = (rng.uniform(-s, s, shape).astype(np.float32) for shape in ((I, 3 * H),
                                                                         (H, 3 * H)))
    bi, bh = (rng.uniform(-s, s, 3 * H).astype(np.float32) for _ in range(2))
    return xs, h0, (wi, wh, bi, bh)


def port_weights(params):
    return gru_kernel_layout(*(torch.from_numpy(p) for p in params), torch.float32)


def test_plain_matches_pallas_interpret():
    xs, h0, params = inputs()
    with pltpu.force_tpu_interpret_mode():
        h_seq, res = gru_scan_forward(jnp.asarray(xs), jnp.asarray(h0),
                                      *(jnp.asarray(p) for p in params))
    ref = (h_seq, *res)
    before = gru_scan.launches
    out = gru_scan(torch.from_numpy(xs), torch.from_numpy(h0), *port_weights(params))
    assert gru_scan.launches == before  # the CPU takes the plain version
    for name, o, r in zip(NAMES, out, ref):
        assert o.shape == (T, B, H) and o.dtype == torch.float32, name
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=TOL, atol=TOL, err_msg=name)


def test_one_step_over_all_rows_gives_the_scan_residuals():
    """The world-model path's form: T = 1 over the T * B pre-step states."""
    xs, h0, params = inputs(1)
    w = port_weights(params)
    xs, h0 = torch.from_numpy(xs), torch.from_numpy(h0)
    out = gru_scan_plain(xs, h0, *w)
    h_prev = torch.cat([h0[None], out[0][:-1]]).reshape(T * B, H)
    one = gru_scan_plain(xs.reshape(1, T * B, I), h_prev, *w)
    for name, o, r in zip(NAMES, one, out):
        np.testing.assert_allclose(o.reshape(T, B, H).numpy(), r.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def _scan_row_by_row(xs, h0, *w):
    """``gru_scan_plain`` one row at a time: like the kernel, its numbers do
    not depend on how many rows share the call."""
    outs = [gru_scan_plain(xs[:, i:i + 1], h0[i:i + 1], *w) for i in range(h0.shape[0])]
    return tuple(torch.cat([o[k] for o in outs], dim=1) for k in range(len(NAMES)))


@pytest.mark.parametrize("fault", ["none", "h_seq", "hn"])
def test_hold_scan_fails_a_launch_its_own_steps_do_not_reproduce(monkeypatch, fault):
    xs, h0, params = inputs(2)
    w = port_weights(params)
    xs, h0 = torch.from_numpy(xs), torch.from_numpy(h0)
    monkeypatch.setattr(gru_scan_cuda, "gru_scan", _scan_row_by_row)
    out = list(_scan_row_by_row(xs, h0, *w))
    if fault != "none":  # the state carried into step 3 of row 1, or a residual
        k = NAMES.index(fault)
        out[k] = out[k].clone()
        out[k][2, 1, 0] = torch.nextafter(out[k][2, 1, 0], torch.tensor(2.0))
    stats = hold_scan(out, xs, h0, w)
    assert (stats["carry_mismatches"] == 0) == (fault == "none"), stats
    assert (stats["failures"] == []) == (fault == "none"), stats
