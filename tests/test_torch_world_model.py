"""The port's world-model update (``train.world_model.wm_update``) against the
JAX package's ``wm_update`` (jitted, the fused deferred-weight-gradient
scans), at the SMALL config of tests/test_imagine_pallas.py with B = 4,
sequence length 8, horizon 6, float32.

Both start from the same parameters and AdamW state (every parameter random,
carried across by ``bridge.load_dreamer_state``), read the same batch and
draw the same gumbels (split from JAX's key as ``observe_sequence`` splits
it).  Two consecutive updates are compared, then a skipped (non-finite)
update, then two of the world model's flags (``terminal_loss_weight``,
``free_bits_per_sample``); tests/test_torch_wm_resets.py holds the two
episode-reset flags.

Tolerances: every metric to 1e-4 rel + 1e-5 abs (losses are means over
B * H terms in float32 summed in another order); the updated parameters to
1e-6 abs, a hundredth of the learning rate; the AdamW moments to 1e-5 rel +
1e-6 abs; the step count and the skip exactly."""

import jax
import numpy as np
import pytest

from _torch_parity import (WM_MOMENT_ATOL, WM_MOMENT_RTOL, WM_PARAM_ATOL, check_wm_flag,
                           port_dreamer_state, same_wm_metrics, same_wm_state, wm_batch,
                           wm_run_both, wm_world)
from dreamer_tpu_torch import bridge

def same_state(w, jwm):
    same_wm_state(w["pstate"], jwm, WM_PARAM_ATOL, WM_MOMENT_RTOL, WM_MOMENT_ATOL)


@pytest.fixture(scope="module")
def world():
    return wm_world()


def fresh(w):
    """The port's state reset to the JAX start state."""
    w["pstate"] = port_dreamer_state(w["trainer"], w["jstate"])
    return w


def test_load_dreamer_state_carries_the_world_model(world):
    w = fresh(world)
    same_state(w, w["jstate"].wm)
    assert bridge.export_dreamer_state(w["pstate"])["step"] == 0


def test_two_updates_match(world):
    w = fresh(world)
    rng = np.random.default_rng(1)
    jwm = w["jstate"].wm
    for i in range(2):
        jwm, jm, pm = wm_run_both(w, jwm, wm_batch(w["cfg"], rng), jax.random.PRNGKey(10 + i))
        assert float(jm["wm/update_skipped"]) == 0.0
        same_wm_metrics(pm, jm)
        same_state(w, jwm)
    assert int(w["pstate"].wm.opt.count) == 2


def test_a_non_finite_update_is_skipped(world):
    w = fresh(world)
    rng = np.random.default_rng(2)
    before = bridge.export_dreamer_state(w["pstate"])["wm"]
    jwm, jm, pm = wm_run_both(w, w["jstate"].wm, wm_batch(w["cfg"], rng, nan=True),
                           jax.random.PRNGKey(20))
    assert float(jm["wm/update_skipped"]) == 1.0 == float(pm["wm/update_skipped"])
    assert np.isnan(float(pm["wm/loss"])) and np.isnan(float(jm["wm/loss"]))
    same_wm_metrics(pm, jm)
    same_state(w, jwm)
    after = bridge.export_dreamer_state(w["pstate"])["wm"]
    assert after["opt"]["count"] == before["opt"]["count"] == 0
    np.testing.assert_array_equal(after["params"]["gru"]["kernel_i"],
                                  before["params"]["gru"]["kernel_i"])


def test_terminal_loss_weight():
    """``wm.terminal_loss_weight`` against JAX, on a batch with episode ends
    (continue 0) under ``env.next_step_autoreset``, whose mask keeps the
    terminal examples that the weight scales."""
    check_wm_flag({"wm.terminal_loss_weight": 5.0, "env.next_step_autoreset": True},
                  "wm.terminal_loss_weight", conts=[(0, 2), (3, 4)], firsts=[(0, 4), (3, 6)])
