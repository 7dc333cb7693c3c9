"""The port's fake env and env farm against the JAX package's, exactly: the
same frames, rewards and flags for the same seeds and actions; the action
space's seeded samples equal to gymnasium's ``Box``; the farm step for step
in both auto-reset modes, with episodes short enough that resets occur, its
seed counter and its seeded random actions included."""

import gymnasium as gym
import numpy as np
import pytest

from dreamer_tpu.envs import EnvFarm as JaxEnvFarm
from dreamer_tpu.envs import make_env as jax_make_env
from dreamer_tpu.envs.fake import FakeEnv as JaxFakeEnv
from dreamer_tpu_torch.envs import EnvFarm, FakeEnv, make_env


def _equal_step(a, b):
    (oa, ra, ta, tra, _), (ob, rb, tb, trb, _) = a, b
    assert oa.dtype == ob.dtype == np.uint8
    np.testing.assert_array_equal(oa, ob)
    assert (ra, ta, tra) == (rb, tb, trb)


@pytest.mark.parametrize("seed,obs_size,episode_len", [(0, (64, 64), 100), (3, (32, 32), 7),
                                                       (123, (16, 48), 12)])
def test_fake_env_equals_jax(seed, obs_size, episode_len):
    rng = np.random.default_rng(seed)
    env = FakeEnv(obs_size=obs_size, episode_len=episode_len)
    ref = JaxFakeEnv(obs_size=obs_size, episode_len=episode_len)
    for episode in range(2):
        (o, _), (o_ref, _) = env.reset(seed=seed + episode), ref.reset(seed=seed + episode)
        np.testing.assert_array_equal(o, o_ref)
        for _ in range(episode_len + 2):
            # Actions past the box too: the env clips its position, not them.
            a = rng.uniform(-1.5, 1.5, size=3).astype(np.float32)
            out = env.step(a)
            _equal_step(out, ref.step(a))
        # render() gives the frame the last step returned.
        np.testing.assert_array_equal(env.render(), out[0])
    # An unseeded reset continues the generator of the last seeded one.
    np.testing.assert_array_equal(env.reset()[0], ref.reset()[0])


def test_action_space_matches_gymnasium_box():
    env = FakeEnv()
    box = gym.spaces.Box(low=-1, high=1, shape=(3,), dtype=np.float32)
    assert env.action_space.shape == box.shape
    np.testing.assert_array_equal(env.action_space.low, box.low)
    np.testing.assert_array_equal(env.action_space.high, box.high)
    for seed in (0, 1, 42, 10_001):
        assert env.action_space.seed(seed) == box.seed(seed)
        for _ in range(20):
            a, b = env.action_space.sample(), box.sample()
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("next_step", [False, True], ids=["same_step", "next_step"])
def test_env_farm_equals_jax(next_step):
    rng = np.random.default_rng(1)
    lens = [5, 8, 13]

    def fns(cls):
        return [lambda n=n: cls(obs_size=(32, 32), episode_len=n) for n in lens]

    farm = EnvFarm(fns(FakeEnv), seed=7, next_step=next_step)
    ref = JaxEnvFarm(fns(JaxFakeEnv), seed=7, next_step=next_step)
    np.testing.assert_array_equal(farm.reset_all(), ref.reset_all())
    resets = 0
    for step in range(40):
        if step % 2:
            actions = rng.uniform(-1, 1, (len(lens), 3)).astype(np.float32)
        else:
            actions = farm.sample_actions()
            np.testing.assert_array_equal(actions, ref.sample_actions())
        out, out_ref = farm.step(actions), ref.step(actions)
        for a, b in zip(out, out_ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        resets += int(out[3].sum())
        assert farm.seed == ref.seed
    assert resets >= 6
    np.testing.assert_array_equal(farm.reset_all(), ref.reset_all())
    assert farm.seed == ref.seed


def test_make_env_builds_the_fake_env_and_refuses_others():
    env = make_env("fake", obs_size=(32, 32), max_episode_steps=9)
    ref = jax_make_env("fake", obs_size=(32, 32), max_episode_steps=9)
    assert (env.obs_size, env.episode_len) == (ref.obs_size, ref.episode_len) == ((32, 32), 9)
    assert make_env("fake").episode_len == 100
    with pytest.raises(ValueError, match="env_factory"):
        make_env("CarRacing-v3")
