"""``runtime.debug_nans`` in the port against ``jax_debug_nans`` in the JAX
package, at the ``configs/fake_smoke.yaml`` widths on the CPU.

A replay ring whose rewards are NaN (frames, actions and continues drawn
from a seed, the same in both packages):

- with the flag, the port's ``wm_step`` raises ``FloatingPointError`` naming
  the ``wm`` update and the reward loss term, before the update's NaN skip;
  through ``Dreamer.train`` the error names the iteration too;
- the JAX ``wm_step`` on the same ring raises ``FloatingPointError`` under
  ``jax_debug_nans`` (the flag restored after);
- without the flag both skip the update: ``wm/update_skipped`` is 1 and the
  port's parameters are unchanged.

The flag's other checks: a NaN policy state raises naming the policy step,
and a non-finite gradient raises naming the ``actor`` update and the
parameter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamer_tpu.config import DreamerConfig as JaxConfig
from dreamer_tpu.train.step import Trainer as JaxTrainer
from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.envs import FakeEnv
from dreamer_tpu_torch.orchestrator import Dreamer
from test_torch_orchestrator import SMOKE, overrides, random_init_state

STEPS = 32


def nan_ring(cfg, rng):
    """Frames, actions and continues of STEPS steps an env, rewards NaN."""
    e, (h, w) = cfg.env.num_envs, cfg.wm.obs_size
    return {"obs": rng.integers(0, 256, (e, STEPS, h, w, 3), dtype=np.uint8),
            "action": rng.uniform(-1, 1, (e, STEPS, cfg.env.action_dim)).astype(np.float32),
            "reward": np.full((e, STEPS), np.nan, np.float32),
            "cont": np.ones((e, STEPS), np.float32)}


def port(tmp, debug, ring):
    d = Dreamer(DreamerConfig.from_yaml(SMOKE, overrides(tmp, **{
        "runtime.debug_nans": debug})), device="cpu")
    for name, value in ring.items():
        getattr(d.buf, name)[:, :STEPS] = torch.from_numpy(value)
    d.buf.next_idx = d.buf.size = STEPS
    return d


def jax_wm_step(tmp, ring, monkeypatch):
    monkeypatch.setattr(JaxTrainer, "init_state", random_init_state)
    jcfg = JaxConfig.from_yaml(SMOKE, overrides(tmp))
    t = JaxTrainer(jcfg)
    state = jax.device_put(t.init_state(jax.random.PRNGKey(0)))
    buf = t.buffer.init_state()
    buf = buf._replace(**{k: getattr(buf, k).at[:, :STEPS].set(v) for k, v in ring.items()},
                       next_idx=jnp.asarray(STEPS, buf.next_idx.dtype),
                       size=jnp.asarray(STEPS, buf.size.dtype))
    return lambda: t.wm_step(state, buf, jax.random.PRNGKey(1))


def test_a_nan_reward_raises_in_the_wm_update_as_in_jax(tmp_path, monkeypatch):
    ring = nan_ring(DreamerConfig.from_yaml(SMOKE), np.random.default_rng(0))
    d = port(tmp_path / "port", True, ring)
    before = [p.clone() for p in d.state.wm.nets.parameters()]
    with pytest.raises(FloatingPointError, match="the wm update .* in wm/reward_ce"):
        d.trainer.wm_step(d.state, d.buf, d.rng)
    assert all(torch.equal(b, p) for b, p in zip(before, d.state.wm.nets.parameters()))

    step = jax_wm_step(tmp_path / "jax", ring, monkeypatch)
    jax.config.update("jax_debug_nans", True)
    try:
        with pytest.raises(FloatingPointError):
            step()
    finally:
        jax.config.update("jax_debug_nans", False)

    # Without the flag both skip the update.
    _, jax_metrics = step()
    assert float(jax_metrics["wm/update_skipped"]) == 1.0
    assert np.isnan(float(jax_metrics["wm/loss"]))
    d = port(tmp_path / "plain", False, ring)
    before = [p.clone() for p in d.state.wm.nets.parameters()]
    _, metrics = d.trainer.wm_step(d.state, d.buf, d.rng)
    assert float(metrics["wm/update_skipped"]) == 1.0 and torch.isnan(metrics["wm/loss"])
    assert all(torch.equal(b, p) for b, p in zip(before, d.state.wm.nets.parameters()))


class NanRewards(FakeEnv):
    def step(self, action):
        obs, _, term, trunc, info = super().step(action)
        return obs, float("nan"), term, trunc, info


def test_train_names_the_iteration(tmp_path):
    cfg = DreamerConfig.from_yaml(SMOKE, overrides(tmp_path, **{"runtime.debug_nans": True}))
    d = Dreamer(cfg, env_factory=lambda: NanRewards(obs_size=(32, 32)), device="cpu")
    with pytest.raises(FloatingPointError,
                       match=r"wm update .* wm/reward_ce, at iteration 0"):
        d.train(progress=False)


def test_a_nan_policy_state_raises(tmp_path):
    d = Dreamer(DreamerConfig.from_yaml(SMOKE, overrides(tmp_path, **{
        "runtime.debug_nans": True})), device="cpu")
    p, n = d.policy, 2
    h = torch.full((n, d.cfg.wm.hidden_dim), float("nan"))
    with pytest.raises(FloatingPointError, match="the policy step .* in action"):
        p.policy_act(h, torch.zeros(n, d.cfg.wm.latent_dim), deterministic=True)


def test_a_nan_gradient_raises_in_the_actor_update(tmp_path):
    d = Dreamer(DreamerConfig.from_yaml(SMOKE, overrides(tmp_path, **{
        "runtime.debug_nans": True})), device="cpu")
    d.rollout_policy(random_policy=True)
    actor = d.state.ac.actor
    hook = next(actor.parameters()).register_hook(lambda g: g * float("nan"))
    name = next(n for n, _ in actor.named_parameters())
    with pytest.raises(FloatingPointError, match=f"the actor update .* gradient of {name}"):
        d.trainer.ac_step(d.state, d.buf, d.rng)
    hook.remove()
