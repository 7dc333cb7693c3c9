"""The port's four policy programs against the JAX Trainer's, at
configs/fake_smoke.yaml widths, from the same parameters, frames and noise.

The noise is drawn from the keys the JAX programs split (``step.py:194-247``):
``jax.random.categorical(k, logp)`` is ``argmax(logp + jax.random.gumbel(k,
logp.shape))``, so handing the port that gumbel noise reproduces JAX's samples.

- float32: sampled one-hots must match exactly; h, z and actions to 1e-5
  abs/rel (float32 sums in another order; measured under 1e-6).
- bfloat16: samples may differ where XLA's per-op bf16 rounding and the
  port's single rounding straddle a gumbel-perturbed tie, so only h and the
  posterior logits are compared, to 2e-2 abs/rel (one bf16 step at |v| < 4).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import configs, f32, jax_params, t
from dreamer_tpu.train.step import Trainer
from dreamer_tpu_torch import bridge
from dreamer_tpu_torch.train import Policy, PolicyNoise

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "fake_smoke.yaml")
TOL_F32 = 1e-5
TOL_BF16 = 2e-2
N = 4


def _build(dtype):
    jcfg, cfg = configs(SMOKE, dtype)
    wm, actor = jax_params(jcfg, seed=1)
    trainer = Trainer(jcfg, jit=False)
    policy = Policy(cfg, device="cpu")
    bridge.load_wm(policy.rssm.nets, wm)
    bridge.load_actor(policy.actor, actor)
    return jcfg, trainer, policy, wm, actor


@pytest.fixture(scope="module")
def f32_setup():
    return _build("float32")


def gumbel(key, cfg, n=N):
    return jax.random.gumbel(key, (n, cfg.wm.latent_rows, cfg.wm.latent_classes), jnp.float32)


def frames(rng, cfg, n=N):
    return rng.integers(0, 256, (n, *cfg.wm.obs_size, 3), dtype=np.uint8)


def same_sample(z_port, z_jax):
    """Exact one-hot agreement, then the STE values to float32 precision."""
    np.testing.assert_array_equal(np.rint(f32(z_port)), np.rint(f32(z_jax)))
    np.testing.assert_allclose(f32(z_port), f32(z_jax), rtol=TOL_F32, atol=TOL_F32)


def close(a, b, tol=TOL_F32):
    np.testing.assert_allclose(f32(a), f32(b), rtol=tol, atol=tol)


def test_policy_reset(f32_setup):
    jcfg, trainer, policy, wm, _ = f32_setup
    obs = frames(np.random.default_rng(0), jcfg)
    key = jax.random.PRNGKey(11)
    h_j, z_j = trainer.policy_reset(wm, jnp.asarray(obs), key)
    h_p, z_p = policy.policy_reset(t(obs), t(gumbel(key, jcfg)))
    close(h_p, h_j)
    same_sample(z_p, z_j)
    assert np.allclose(f32(z_p).reshape(N, jcfg.wm.latent_rows, -1).sum(-1), 1.0)


@pytest.mark.parametrize("deterministic", [False, True])
def test_policy_act(f32_setup, deterministic):
    jcfg, trainer, policy, _, actor = f32_setup
    rng = np.random.default_rng(1)
    h = rng.standard_normal((N, jcfg.wm.hidden_dim)).astype(np.float32)
    z = rng.standard_normal((N, jcfg.wm.latent_dim)).astype(np.float32)
    key = jax.random.PRNGKey(12)
    a_j = trainer.policy_act(actor, jnp.asarray(h), jnp.asarray(z), key,
                             deterministic=deterministic)
    eps = jax.random.normal(key, (N, jcfg.env.action_dim), jnp.float32)
    a_p = policy.policy_act(t(h), t(z), None if deterministic else t(eps), deterministic)
    close(a_p, a_j)
    assert float(a_p.abs().max()) <= 1.0


def test_policy_observe(f32_setup):
    jcfg, trainer, policy, wm, _ = f32_setup
    rng = np.random.default_rng(2)
    obs = frames(rng, jcfg)
    key = jax.random.PRNGKey(13)
    h0, z0 = trainer.policy_reset(wm, jnp.asarray(frames(rng, jcfg)), jax.random.PRNGKey(0))
    a = rng.uniform(-1, 1, (N, jcfg.env.action_dim)).astype(np.float32)
    z_j, h_j = trainer.policy_observe(wm, z0, h0, jnp.asarray(a), jnp.asarray(obs), key)
    z_p, h_p = policy.policy_observe(t(z0), t(h0), t(a), t(obs), t(gumbel(key, jcfg)))
    close(h_p, h_j)
    same_sample(z_p, z_j)


def test_policy_act_observe_rollout(f32_setup):
    """Five steps with reset rows, each side carrying its own state."""
    jcfg, trainer, policy, wm, actor = f32_setup
    rng = np.random.default_rng(3)
    key = jax.random.PRNGKey(14)
    first = frames(rng, jcfg)
    h_j, z_j = trainer.policy_reset(wm, jnp.asarray(first), key)
    h_p, z_p = policy.policy_reset(t(first), t(gumbel(key, jcfg)))
    a_j = jnp.zeros((N, jcfg.env.action_dim))
    a_p = torch.zeros(N, jcfg.env.action_dim)
    for step in range(5):
        obs = frames(rng, jcfg)
        done = np.zeros(N, bool)
        done[step % N] = step in (2, 3)
        key = jax.random.fold_in(key, step)
        h_j, z_j, a_j = trainer.policy_act_observe(wm, actor, h_j, z_j, a_j, jnp.asarray(obs),
                                                   jnp.asarray(done), key)
        k_obs, k_reset, k_act = jax.random.split(key, 3)
        noise = PolicyNoise(t(gumbel(k_obs, jcfg)), t(gumbel(k_reset, jcfg)),
                            t(jax.random.normal(k_act, (N, jcfg.env.action_dim))))
        h_p, z_p, a_p = policy.policy_act_observe(h_p, z_p, a_p, t(obs), t(done), noise)
        close(h_p, h_j)
        same_sample(z_p, z_j)
        close(a_p, a_j)
        assert np.all(f32(h_p)[done] == 0.0)


def test_policy_act_observe_deterministic(f32_setup):
    jcfg, trainer, policy, wm, actor = f32_setup
    rng = np.random.default_rng(4)
    h0, z0 = trainer.policy_reset(wm, jnp.asarray(frames(rng, jcfg)), jax.random.PRNGKey(1))
    obs = frames(rng, jcfg)
    a = rng.uniform(-1, 1, (N, jcfg.env.action_dim)).astype(np.float32)
    done = np.array([True, False, False, True])
    key = jax.random.PRNGKey(15)
    out_j = trainer.policy_act_observe(wm, actor, h0, z0, jnp.asarray(a), jnp.asarray(obs),
                                       jnp.asarray(done), key, deterministic=True)
    k_obs, k_reset, _ = jax.random.split(key, 3)
    noise = PolicyNoise(t(gumbel(k_obs, jcfg)), t(gumbel(k_reset, jcfg)), None)
    out_p = policy.policy_act_observe(t(h0), t(z0), t(a), t(obs), t(done), noise,
                                      deterministic=True)
    close(out_p[0], out_j[0])
    same_sample(out_p[1], out_j[1])
    close(out_p[2], out_j[2])


def test_bf16_observe_h_and_logits():
    jcfg, trainer, policy, wm, _ = _build("bfloat16")
    rng = np.random.default_rng(5)
    h = np.tanh(rng.standard_normal((N, jcfg.wm.hidden_dim))).astype(np.float32)
    z = np.eye(jcfg.wm.latent_classes, dtype=np.float32)[
        rng.integers(0, jcfg.wm.latent_classes, (N, jcfg.wm.latent_rows))].reshape(N, -1)
    a = rng.uniform(-1, 1, (N, jcfg.env.action_dim)).astype(np.float32)
    obs = frames(rng, jcfg)
    key = jax.random.PRNGKey(16)
    _, h_j, logits_j = trainer.rssm.observe_step(
        wm, jnp.asarray(z), jnp.asarray(h), jnp.asarray(a),
        jnp.asarray(obs, jnp.float32) / 255.0 - 0.5, key)
    _, h_p, logits_p = policy.rssm.observe_step(t(z), t(h), t(a), t(obs),
                                                t(gumbel(key, jcfg)))
    assert h_p.dtype == torch.float32 and logits_p.dtype == torch.bfloat16
    close(h_p, h_j, TOL_BF16)
    close(logits_p, logits_j, TOL_BF16)
    # The fused program's h' is the same GRU step for rows that do not reset.
    done = np.array([False, True, False, False])
    k_obs, k_reset, k_act = jax.random.split(key, 3)
    noise = PolicyNoise(t(gumbel(k_obs, jcfg)), t(gumbel(k_reset, jcfg)),
                        t(jax.random.normal(k_act, (N, jcfg.env.action_dim))))
    h2, z2, a2 = policy.policy_act_observe(t(h), t(z), t(a), t(obs), t(done), noise)
    close(h2[~t(done)], f32(h_j)[~done], TOL_BF16)
    assert float(h2[1].abs().max()) == 0.0 and bool(torch.isfinite(a2).all())
