"""The port's ``Dreamer`` acting with its policy, held against the JAX
package's ``Dreamer`` at the ``configs/fake_smoke.yaml`` widths in float32 on
the CPU, from the same weights (through ``bridge``) and the same noise.

The noise: JAX's ``Dreamer`` splits one key from its rollout stream
(``PRNGKey(train.seed + 1)``) for each policy call, ``_rollout_key``; the
port's draws (``Dreamer._gumbel``, ``Dreamer._eps``, ``Policy.sample_noise``)
are fed what JAX draws from those keys, a deterministic action consuming a
key unused as JAX's does.  The test's own copy of that stream ends where
JAX's does, so both made the same policy calls.

- Two policy rollout rounds (the stream start's first action included, an
  episode reset inside the second) fill the port's ring as JAX's: frames
  and continues exact, actions and rewards to 1e-5
  absolute (float32 sums in another order; measured under 1e-6), the farm's
  seed equal (same-step auto-reset, the configs' default; the kickstart
  test of ``test_torch_orchestrator.py`` covers both modes).
- One batched ``evaluate_agent`` over episodes of 3, 6 and 11 steps, so the
  rows compact from 3 to 2 to 1: every action each eval env is given, and
  the mean reward, to 1e-5."""

import jax
import numpy as np
import torch

from dreamer_tpu.config import DreamerConfig as JaxConfig
from dreamer_tpu.envs import EnvFarm as JaxEnvFarm
from dreamer_tpu.envs import FakeEnv as JaxFakeEnv
from dreamer_tpu.orchestrator import Dreamer as JaxDreamer
from dreamer_tpu.train.step import Trainer as JaxTrainer
from dreamer_tpu_torch import bridge
from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.envs import EnvFarm, FakeEnv
from dreamer_tpu_torch.orchestrator import Dreamer
from dreamer_tpu_torch.train.step import PolicyNoise
from test_torch_orchestrator import SMOKE, overrides, random_init_state

TOL = 1e-5
EVAL_LENS = (3, 6, 11)


class JaxDraws:
    """The rollout stream of JAX's ``Dreamer``: one ``split`` a policy call,
    each key turned into the noise the port's call takes."""

    def __init__(self, cfg):
        self.key = jax.random.PRNGKey(cfg.train.seed + 1)
        self.latent = (cfg.wm.latent_rows, cfg.wm.latent_classes)
        self.action_dim = cfg.env.action_dim

    def next(self):
        self.key, k = jax.random.split(self.key)
        return k

    def gumbel(self, n, key=None):
        key = self.next() if key is None else key
        return torch.from_numpy(np.array(jax.random.gumbel(key, (n, *self.latent))))

    def eps(self, n, key=None):
        key = self.next() if key is None else key
        return torch.from_numpy(np.array(jax.random.normal(key, (n, self.action_dim))))

    def noise(self, n):
        k_obs, k_reset, k_act = jax.random.split(self.next(), 3)   # step.py:232
        return PolicyNoise(self.gumbel(n, k_obs), self.gumbel(n, k_reset), self.eps(n, k_act))


def feed_jax_draws(d):
    """Route every draw of the port's rollout and eval through ``JaxDraws``."""
    draws = JaxDraws(d.cfg)
    d._gumbel, d._eps = draws.gumbel, draws.eps
    d.policy.sample_noise = lambda n, generator: draws.noise(n)
    act = d.policy.policy_act

    def policy_act(h, z, eps=None, deterministic=False):
        if deterministic:
            draws.next()   # JAX splits a key for a deterministic action too
        return act(h, z, eps, deterministic)

    d.policy.policy_act = policy_act
    return draws


def recording(env_cls, log):
    class Recorded(env_cls):
        def step(self, action):
            log.setdefault(id(self), []).append(np.asarray(action, np.float32).copy())
            return super().step(action)

    return Recorded


def test_policy_rollout_and_eval_equal_jax(tmp_path, monkeypatch):
    kw = {"env.max_episode_steps": 20}
    monkeypatch.setattr(JaxTrainer, "init_state", random_init_state)
    jd = JaxDreamer(JaxConfig.from_yaml(SMOKE, overrides(tmp_path / "jax", **kw)))
    d = Dreamer(DreamerConfig.from_yaml(SMOKE, overrides(tmp_path / "port", **kw)),
                device="cpu")
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
    assert float(b.cont.min()) == 0.0   # an episode ended inside the second round
    assert d.farm.seed == jd.farm.seed == 2 + 2

    got, want = {}, {}
    obs_size = tuple(d.cfg.wm.obs_size)
    d._eval_farm = EnvFarm([lambda n=n: recording(FakeEnv, got)(obs_size=obs_size,
                                                                 episode_len=n)
                            for n in EVAL_LENS], seed=0)
    jd._eval_farm = JaxEnvFarm([lambda n=n: recording(JaxFakeEnv, want)(obs_size=obs_size,
                                                                         episode_len=n)
                                for n in EVAL_LENS], seed=0)
    reward = d.evaluate_agent(len(EVAL_LENS), max_steps=50)
    want_reward = jd.evaluate_agent(len(EVAL_LENS), max_steps=50)
    np.testing.assert_allclose(reward, want_reward, rtol=TOL, atol=TOL)
    port_acts = [np.stack(got[id(e)]) for e in d._eval_farm.envs]
    jax_acts = [np.stack(want[id(e)]) for e in jd._eval_farm.envs]
    assert [len(a) for a in port_acts] == [len(a) for a in jax_acts] == list(EVAL_LENS)
    for p, j in zip(port_acts, jax_acts):
        np.testing.assert_allclose(p, j, rtol=0, atol=TOL)
    assert d._eval_seed == jd._eval_seed
    # Both made the same number of policy calls.
    np.testing.assert_array_equal(np.asarray(draws.key), np.asarray(jd.rollout_rng))
