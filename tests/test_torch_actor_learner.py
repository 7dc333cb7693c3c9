"""The port's actor-learner split (``runtime.rollout_device='cpu'``,
``runtime.broadcast_dtype``, ``runtime.async_rollout``) at the
``configs/fake_smoke.yaml`` widths on the CPU, held against the JAX
package's ``Dreamer`` where it has a counterpart.

- The weight wire (``orchestrator.broadcast``) equals JAX's
  ``Dreamer._make_broadcast_fns`` bit for bit, in float32 and bfloat16: the
  same multiset of wire values, and every actor parameter after the
  broadcast equal to JAX's unflattened leaf (through ``bridge``).
- The host-local actor acts in float32 as JAX's does: under a bfloat16
  learner, two rollout rounds and a compacting batched eval equal JAX's
  ``rollout_device='cpu'`` ``Dreamer``'s to 1e-5 from the same weights and
  noise (``feed_jax_draws``).
- The broadcast cache (``tests/test_actor_learner.py``): no copy while the
  learner's weights are unchanged, one after a ``wm_step``; a CPU learner's
  update leaves the actor's weights alone until the next broadcast.
- ``async_rollout``: refused without the host-local actor as JAX refuses
  it; 4 overlapped iterations fill the ring with every round; an overlapped
  run equals, bit for bit, the sequential schedule it overlaps (collect
  with the weights of before the update, update, then write); a raise in
  the rollout thread surfaces from ``train()``.
The card's side is in ``test_torch_actor_learner_cuda.py``, which imports
nothing of JAX."""

import types

import jax
import numpy as np
import pytest
import torch

from dreamer_tpu.config import DreamerConfig as JaxConfig
from dreamer_tpu.envs import EnvFarm as JaxEnvFarm
from dreamer_tpu.envs import FakeEnv as JaxFakeEnv
from dreamer_tpu.orchestrator import Dreamer as JaxDreamer
from dreamer_tpu.train.step import Trainer as JaxTrainer
from dreamer_tpu_torch import bridge
from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.envs import EnvFarm, FakeEnv
from dreamer_tpu_torch.orchestrator import Dreamer, broadcast
from test_torch_orchestrator import SMOKE, overrides, random_init_state
from test_torch_orchestrator_policy import EVAL_LENS, TOL, feed_jax_draws, recording

HOST = {"runtime.rollout_device": "cpu"}


def port(tmp, **kw):
    return Dreamer(DreamerConfig.from_yaml(SMOKE, overrides(tmp, **kw)), device="cpu")


def actor_weights(d):
    return [*d.policy.rssm.nets.parameters(), *d.policy.actor.parameters()]


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_the_wire_equals_jax_bit_for_bit(tmp_path, monkeypatch, wire):
    monkeypatch.setattr(JaxTrainer, "init_state", random_init_state)
    jcfg = JaxConfig.from_yaml(SMOKE, overrides(tmp_path / "jax",
                                                **{"runtime.broadcast_dtype": wire}))
    jstate = jax.tree.map(np.asarray, JaxTrainer(jcfg, jit=False).init_state(
        jax.random.PRNGKey(0)))
    params = (jstate.wm.params, jstate.ac.actor_params)
    host = types.SimpleNamespace(cfg=jcfg, _plan=None,
                                 _cpu_device=jax.local_devices(backend="cpu")[0])
    flatten, unflatten = JaxDreamer._make_broadcast_fns(host, params)
    jax_flat = np.asarray(flatten(params))
    jax_wm, jax_actor = jax.tree.map(np.asarray, unflatten(jax_flat))

    d = port(tmp_path / "port", **HOST, **{"runtime.broadcast_dtype": wire})
    bridge.load_dreamer_state(d.state, jstate)
    flat = broadcast.flatten(d._learner_weights(), getattr(torch, wire))
    assert flat.device.type == "cpu" and str(flat.dtype) == f"torch.{wire}"
    assert flat.numel() == jax_flat.size and flat.element_size() == jax_flat.itemsize
    # The same wire values (JAX orders its leaves by name, the port by module).
    np.testing.assert_array_equal(np.sort(flat.float().numpy()),
                                  np.sort(jax_flat.astype(np.float32)))
    broadcast.unflatten(flat, actor_weights(d))
    want = port(tmp_path / "want", **HOST)
    bridge.load_wm(want.policy.rssm.nets, jax_wm)
    bridge.load_actor(want.policy.actor, jax_actor)
    got_w, want_w = actor_weights(d), actor_weights(want)
    assert all(g.dtype == torch.float32 for g in got_w)
    for g, w in zip(got_w, want_w, strict=True):
        assert torch.equal(g, w)
    if wire == "bfloat16":
        assert any(not torch.equal(g, l) for g, l in zip(got_w, d._learner_weights()))


def test_host_actor_rollout_and_eval_equal_jax(tmp_path, monkeypatch):
    kw = {**HOST, "env.max_episode_steps": 20, "runtime.compute_dtype": "bfloat16"}
    monkeypatch.setattr(JaxTrainer, "init_state", random_init_state)
    jd = JaxDreamer(JaxConfig.from_yaml(SMOKE, overrides(tmp_path / "jax", **kw)))
    jd.state = jax.device_put(jd.state)   # _policy_params reads the leaves' devices
    d = port(tmp_path / "port", **kw)
    assert d.trainer.dtype == torch.bfloat16 and d.policy.dtype == torch.float32
    assert d.policy.device.type == "cpu" and d.rollout_rng.device.type == "cpu"
    bridge.load_dreamer_state(d.state, jax.tree.map(np.asarray, jd.state))
    draws = feed_jax_draws(d)

    for _ in range(2):
        jd.rollout_policy(random_policy=False)
        d.rollout_policy(random_policy=False)
    jb, b = jd.buf, d.buf
    for name in ("obs", "cont"):
        np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(jb, name)),
                                      err_msg=name)
    for name in ("action", "reward"):
        np.testing.assert_allclose(getattr(b, name).numpy(), np.asarray(getattr(jb, name)),
                                   rtol=0, atol=TOL, err_msg=name)
    assert (b.next_idx, b.size) == (int(jb.next_idx), int(jb.size)) == (32, 32)
    assert float(b.cont.min()) == 0.0

    got, want = {}, {}
    obs_size = tuple(d.cfg.wm.obs_size)
    d._eval_farm = EnvFarm([lambda n=n: recording(FakeEnv, got)(obs_size=obs_size,
                                                                 episode_len=n)
                            for n in EVAL_LENS], seed=0)
    jd._eval_farm = JaxEnvFarm([lambda n=n: recording(JaxFakeEnv, want)(obs_size=obs_size,
                                                                         episode_len=n)
                                for n in EVAL_LENS], seed=0)
    reward = d.evaluate_agent(len(EVAL_LENS), max_steps=50)
    np.testing.assert_allclose(reward, jd.evaluate_agent(len(EVAL_LENS), max_steps=50),
                               rtol=TOL, atol=TOL)
    for e, je in zip(d._eval_farm.envs, jd._eval_farm.envs):
        p, j = np.stack(got[id(e)]), np.stack(want[id(je)])
        assert len(p) == len(j)
        np.testing.assert_allclose(p, j, rtol=0, atol=TOL)
    assert sorted(len(v) for v in got.values()) == list(EVAL_LENS)
    np.testing.assert_array_equal(np.asarray(draws.key), np.asarray(jd.rollout_rng))


def test_no_broadcast_while_the_weights_are_unchanged(tmp_path):
    d = port(tmp_path, **HOST)
    d.rollout_policy(random_policy=True)
    first = actor_weights(d)[0]
    with torch.no_grad():
        first.zero_()   # a copy would undo this
    d._refresh_actor()
    assert not first.any()
    d.state, _ = d.trainer.wm_step(d.state, d.buf, d.rng)
    d._refresh_actor()
    for a, w in zip(actor_weights(d), d._learner_weights(), strict=True):
        assert torch.equal(a, w) and a.data_ptr() != w.data_ptr()


def test_a_cpu_learners_update_does_not_reach_the_actor_before_a_broadcast(tmp_path):
    d = port(tmp_path, **HOST)
    d.rollout_policy(random_policy=True)
    before = [a.clone() for a in actor_weights(d)]
    d.state, _ = d.trainer.train_iteration(d.state, d.buf, d.rng)
    assert any(not torch.equal(b, w) for b, w in zip(before, d._learner_weights()))
    assert all(torch.equal(b, a) for b, a in zip(before, actor_weights(d)))
    d.rollout_policy(random_policy=False)
    assert all(torch.equal(a, w) for a, w in zip(actor_weights(d), d._learner_weights()))


def test_async_rollout_needs_the_host_actor(tmp_path):
    with pytest.raises(ValueError, match="requires runtime.rollout_device='cpu'"):
        port(tmp_path, **{"runtime.async_rollout": True})
