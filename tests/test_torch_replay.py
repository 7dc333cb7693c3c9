"""The port's replay ring (``replay.buffer``) against the JAX package's: ring
writes that wrap (exactly equal contents, head and size), window gathers from
the same indices, and the (env, start) choice with the head-collision re-roll
from the three integer draws JAX makes (injected into ``pick_indices``).
Everything is compared exactly: the ring stores what it is given (rewards
symlog'd in float32 on both sides, equal to 1 ulp, held to 1e-6 rel)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamer_tpu.replay import ReplayBuffer as JaxReplayBuffer
from dreamer_tpu_torch.replay import ReplayBuffer

E, C, T, A, OBS = 2, 12, 5, 3, (8, 8)


def chunk(rng, n, firsts):
    out = [rng.integers(0, 256, (E, n, *OBS, 3), dtype=np.uint8),
           rng.uniform(-1, 1, (E, n, A)).astype(np.float32),
           (rng.standard_normal((E, n)) * 5).astype(np.float32),
           (rng.uniform(0, 1, (E, n)) > 0.2).astype(np.float32)]
    return out + ([(rng.uniform(0, 1, (E, n)) > 0.7).astype(np.float32)] if firsts else [])


def same_ring(port, ref):
    for name in ("obs", "action", "cont", "first"):
        r = getattr(ref, name)
        if r is None:
            assert getattr(port, name) is None
            continue
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(r), err_msg=name)
    np.testing.assert_allclose(port.reward.numpy(), np.asarray(ref.reward), rtol=1e-6)
    assert (port.next_idx, port.size) == (int(ref.next_idx), int(ref.size))


def buffers(firsts):
    return (ReplayBuffer(E * C, T, A, OBS, num_envs=E, store_firsts=firsts),
            JaxReplayBuffer(E * C, T, A, OBS, num_envs=E, store_firsts=firsts))


@pytest.mark.parametrize("firsts", [False, True])
def test_ring_writes_wrap_like_jax(firsts):
    rng = np.random.default_rng(0)
    port, ref = buffers(firsts)
    ps, rs = port.init_state(), ref.init_state()
    for n in (5, 4, 7, 30):  # fills, wraps, then one chunk longer than the ring
        c = chunk(rng, n, firsts)
        ps = port.add_batch(ps, *map(torch.from_numpy, c))
        rs = ref.add_batch(rs, *map(jnp.asarray, c))
        same_ring(ps, rs)


@pytest.mark.parametrize("t_out,with_scalars", [(None, True), (3, True), (2, False)])
def test_gathers_match_from_the_same_indices(t_out, with_scalars):
    rng = np.random.default_rng(1)
    port, ref = buffers(True)
    ps, rs = port.init_state(), ref.init_state()
    c = chunk(rng, 17, True)
    ps = port.add_batch(ps, *map(torch.from_numpy, c))
    rs = ref.add_batch(rs, *map(jnp.asarray, c))
    env_idx = np.array([0, 1, 1, 0, 1], np.int32)
    starts = np.array([0, 3, 7, 9, 11], np.int32)  # windows that wrap the ring too
    got = port.gather(ps, torch.from_numpy(env_idx).long(), torch.from_numpy(starts).long(),
                      t_out, with_scalars)
    want = ref._gather(rs, jnp.asarray(env_idx), jnp.asarray(starts), t_out, with_scalars)
    assert len(got) == len(want) == (5 if with_scalars else 2)
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 2:  # the symlog'd rewards
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("fill", [9, 12, 30])  # not full; full with the head at 0; wrapped
def test_draws_and_the_head_collision_reroll_match(fill):
    rng = np.random.default_rng(2)
    port, ref = buffers(False)
    ps, rs = port.init_state(), ref.init_state()
    for n in (fill, 3):
        c = chunk(rng, n, False)
        ps = port.add_batch(ps, *map(torch.from_numpy, c))
        rs = ref.add_batch(rs, *map(jnp.asarray, c))
    batch = 64
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        k1, k2, k3 = jax.random.split(key, 3)
        valid = port.valid_starts(ps)
        assert valid == max(int(rs.size) - T + 1, 1)
        draws = [jax.random.randint(k1, (batch,), 0, E),
                 jax.random.randint(k2, (batch,), 0, valid),
                 jax.random.randint(k3, (batch,), 0, valid)]
        env_idx, starts = port.pick_indices(ps, *(torch.from_numpy(np.array(d)).long()
                                                  for d in draws))
        want_e, want_s = ref._draw_indices(rs, key, batch)
        np.testing.assert_array_equal(env_idx.numpy(), np.asarray(want_e))
        np.testing.assert_array_equal(starts.numpy(), np.asarray(want_s))
        if fill == 30:  # the ring is full: some windows held the head and were re-rolled
            assert bool((starts != torch.from_numpy(np.array(draws[1])).long()).any())


def test_sample_draws_from_the_generator():
    rng = np.random.default_rng(3)
    port, _ = buffers(False)
    ps = port.add_batch(port.init_state(), *map(torch.from_numpy, chunk(rng, 10, False)))
    a = port.sample(ps, 6, torch.Generator().manual_seed(4), t_out=3)
    b = port.sample(ps, 6, torch.Generator().manual_seed(4), t_out=3)
    assert a[0].shape == (6, 3, *OBS, 3) and a[0].dtype == torch.uint8
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == 4
    with pytest.raises(ValueError, match="t_out"):
        port.sample(ps, 2, torch.Generator(), t_out=T + 1)
