"""The world-model update's flags against the JAX package, each on its own
config (the set-up and tolerances of tests/test_torch_world_model.py, in
``_torch_parity``): one update from the same state, batch and gumbels, after
showing that the flag changes the port's loss on that batch.

- ``wm.free_bits_per_sample``: the free-bits floor (2.7 nats, about the
  median per-sample KL of this world) taken per (b, t) before the mean;
- ``wm.reset_on_episode_start``: the posterior scan's resets derived from
  the continue flags (``observe_scan_reset``);
- ``env.next_step_autoreset``: the ring's episode-start channel drives the
  resets and the mask ``1 - firsts[:, 1:H]``."""

import pytest

from _torch_parity import check_wm_flag


@pytest.mark.parametrize("flags,toggled,conts,firsts", [
    ({"wm.free_bits_per_sample": True, "wm.free_bits": 2.7}, "wm.free_bits_per_sample",
     (), None),
    ({"wm.reset_on_episode_start": True}, "wm.reset_on_episode_start",
     [(0, 2), (2, 1), (3, 3)], None),
    ({"env.next_step_autoreset": True}, "env.next_step_autoreset",
     [(1, 2)], [(1, 4), (2, 3), (0, 0)]),
], ids=["free_bits_per_sample", "reset_on_episode_start", "next_step_autoreset"])
def test_flag_matches_jax(flags, toggled, conts, firsts):
    check_wm_flag(flags, toggled, conts, firsts)
