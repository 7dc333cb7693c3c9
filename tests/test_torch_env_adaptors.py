"""The port's wrapper stack (``dreamer_tpu_torch.envs.adaptors``) against the
JAX package's (``dreamer_tpu/envs/adaptors.py``, which uses OpenCV here),
exactly.

- Each wrapper on the fake env against the JAX class on the JAX fake env:
  frames, rewards (value and Python type), flags, the actions that reach the
  base env (value and dtype) and the spaces, over episodes that end inside
  the test; ``RenderSkippingActionRepeat`` on a fake env that renders its
  observation in ``step()`` as CarRacing does, with its render count.
- ``resize_area`` against ``cv2.resize(..., INTER_AREA)`` bit for bit, on
  random frames at 84x96 (CarRacing after the crop), 96x96, 400x600
  (LunarLander's render), 600x400, whole factors (2 and 3) and an upscale,
  and on real CarRacing and LunarLander frames.
- ``make_env(..., base_make="gymnasium:make")`` against the JAX ``make_env``
  on the real ``CarRacing-v3`` (fast path and ``fast_repeat=False``),
  ``LunarLander-v3`` and ``BipedalWalkerHardcore-v3`` with the same seed and
  seeded random actions for 20 agent steps: frames, rewards and flags equal.
- The errors: PyFlyt missing, no maker for a real id, a malformed maker; the
  default factory pickles."""

import functools
import pickle

import cv2
import gymnasium as gym
import numpy as np
import pytest

from dreamer_tpu.envs import adaptors as jax_adaptors
from dreamer_tpu.envs import make_env as jax_make_env
from dreamer_tpu.envs.fake import FakeEnv as JaxFakeEnv
from dreamer_tpu_torch.envs import FakeEnv, adaptors, make_env, resize_area

STEPS = 12


def recorded(cls):
    """``cls`` recording every action its ``step`` receives, and rendering
    its current frame."""
    class Recorded(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.actions = []

        def step(self, action):
            self.actions.append(np.array(action, copy=True))
            return super().step(action)

        def render(self):
            return self._render_obs()

    return Recorded


def state_pixels(cls):
    """``cls`` rendering its observation inside ``step()`` through
    ``_render("state_pixels")`` into ``.state``, as CarRacing-v3 does, and
    counting its renders."""
    class StatePixels(recorded(cls)):
        renders = 0

        def _render(self, mode):
            self.renders += 1
            return self._render_obs()

        def reset(self, *, seed=None, options=None):
            _, info = super().reset(seed=seed, options=options)
            self.state = self._render("state_pixels")
            return self.state, info

        def step(self, action):
            _, reward, terminated, truncated, info = super().step(action)
            self.state = self._render("state_pixels")
            return self.state, reward, terminated, truncated, info

    return StatePixels


# name: (wrap(module, base env), base env kwargs)
STACKS = {
    "crop": (lambda m, e: m.CropObservation(e, rows=20), {}),
    "resize": (lambda m, e: m.ResizeObservation(e, (16, 24)), {}),
    "action_repeat": (lambda m, e: m.ActionRepeat(e, repeat=3), {}),
    "pixel": (lambda m, e: m.ResizeObservation(m.PixelObservation(m.ActionRepeat(e, 2)),
                                               (16, 16)), {}),
    "car_racer": (lambda m, e: m.CarRacerAdaptor(e), {}),
    "drone": (lambda m, e: m.DroneAdaptor(e), {"action_dim": 4}),
    "render_skipping": (lambda m, e: m.CropObservation(
        m.RenderSkippingActionRepeat(e, repeat=4), rows=24), {}),
}


def same_space(space, ref):
    assert space.shape == ref.shape
    assert space.dtype == ref.dtype
    np.testing.assert_array_equal(space.low, ref.low)
    np.testing.assert_array_equal(space.high, ref.high)


@pytest.mark.parametrize("name", sorted(STACKS))
def test_wrapper_equals_jax_on_the_fake_env(name):
    wrap, kw = STACKS[name]
    make = state_pixels if name == "render_skipping" else recorded
    base = make(FakeEnv)(obs_size=(32, 48), episode_len=7, **kw)
    base_ref = make(JaxFakeEnv)(obs_size=(32, 48), episode_len=7, **kw)
    env, ref = wrap(adaptors, base), wrap(jax_adaptors, base_ref)
    same_space(env.action_space, ref.action_space)
    same_space(env.observation_space, ref.observation_space)
    assert env.unwrapped is base
    rng = np.random.default_rng(3)
    dim = env.action_space.shape[0]
    episodes = 0
    (obs, _), (obs_ref, _) = env.reset(seed=11), ref.reset(seed=11)
    for _ in range(STEPS):
        assert obs.dtype == obs_ref.dtype == np.uint8
        np.testing.assert_array_equal(obs, obs_ref)
        a = rng.uniform(-1, 1, dim).astype(np.float32)
        obs, reward, term, trunc, _ = env.step(a)
        obs_ref, reward_ref, term_ref, trunc_ref, _ = ref.step(a)
        assert (reward, term, trunc) == (reward_ref, term_ref, trunc_ref)
        assert type(reward) is type(reward_ref)
        if term or trunc:
            episodes += 1
            (obs, _), (obs_ref, _) = env.reset(), ref.reset()
    np.testing.assert_array_equal(obs, obs_ref)
    assert episodes >= 1
    assert len(base.actions) == len(base_ref.actions) > 0
    for a, b in zip(base.actions, base_ref.actions):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if name == "render_skipping":
        assert base.renders == base_ref.renders


def test_render_skipping_renders_only_observed_frames():
    """``tests/test_envs.py``'s render-count case: an episode ending inside
    the repeat re-renders its terminal frame; otherwise one render a step."""
    env = adaptors.RenderSkippingActionRepeat(state_pixels(FakeEnv)(episode_len=2), repeat=4)
    env.reset(seed=0)
    obs, reward, _, trunc, _ = env.step(np.zeros(3, np.float32))
    assert trunc and env.unwrapped.renders == 2   # reset + the terminal re-render
    np.testing.assert_array_equal(obs, env.unwrapped._render_obs())
    env = adaptors.RenderSkippingActionRepeat(state_pixels(FakeEnv)(episode_len=100), repeat=4)
    env.reset(seed=0)
    env.step(np.zeros(3, np.float32))
    assert env.unwrapped.renders == 2             # reset + the last frame only


def test_drone_adaptor_maps_actions():
    """``tests/test_drone.py``'s cases on the port's fake env."""
    env = adaptors.DroneAdaptor(FakeEnv(obs_size=(16, 16), action_dim=4))
    a = np.array([0.5, -0.25, 1.0, -1.0], dtype=np.float32)
    mapped = env.action(a)
    np.testing.assert_array_equal(mapped, a)
    assert mapped.dtype == np.float32
    assert env.action_space.shape == (4,) and float(env.action_space.low[0]) == -1.0
    obs, _ = env.reset(seed=0)
    obs2, reward, _, _, _ = env.step(env.action_space.sample())
    assert obs2.shape == obs.shape and np.isfinite(reward)


def test_car_racer_adaptor_maps_gas_and_brake():
    out = adaptors.CarRacerAdaptor(FakeEnv()).action(np.array([0.5, 1.0, -1.0], np.float32))
    assert out.dtype == np.float64
    np.testing.assert_array_equal(out, [0.5, 1.0, 0.0])


def test_wrapper_falls_through_to_the_env():
    env = adaptors.ActionRepeat(adaptors.CropObservation(FakeEnv(episode_len=9), rows=8), 2)
    assert env.episode_len == 9 and env.rows == 8
    with pytest.raises(AttributeError):
        env._pos


@pytest.mark.parametrize("shape,size", [((84, 96), (64, 64)), ((96, 96), (64, 64)),
                                        ((400, 600), (64, 64)), ((600, 400), (64, 64)),
                                        ((128, 128), (64, 64)), ((96, 144), (32, 48)),
                                        ((32, 24), (64, 64))],
                         ids=["84x96", "96x96", "400x600", "600x400", "factor2", "factor3",
                              "upscale"])
def test_resize_area_equals_cv2(shape, size):
    rng = np.random.default_rng(sum(shape))
    for _ in range(3):
        frame = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
        want = cv2.resize(frame, (size[1], size[0]), interpolation=cv2.INTER_AREA)
        got = resize_area(frame, size)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_resize_area_equals_cv2_on_real_frames():
    car = gym.make("CarRacing-v3", continuous=True)
    lander = gym.make("LunarLander-v3", continuous=True, render_mode="rgb_array")
    frames = []
    try:
        obs, _ = car.reset(seed=1)
        lander.reset(seed=1)
        for i in range(60):
            obs, *_ = car.step(np.array([0.3, 0.6, 0.0]))
            lander.step(np.array([0.5, 0.1], np.float32))
            if i % 20 == 19:
                frames += [obs[:84], obs, lander.render()]
    finally:
        car.close()
        lander.close()
    assert {f.shape for f in frames} == {(84, 96, 3), (96, 96, 3), (400, 600, 3)}
    for frame in frames:
        want = cv2.resize(frame, (64, 64), interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(resize_area(frame, (64, 64)), want)


REAL = [("CarRacing-v3", {}), ("CarRacing-v3", {"fast_repeat": False}),
        ("LunarLander-v3", {"crop_rows": None, "action_repeat": 2}),
        ("BipedalWalkerHardcore-v3", {"crop_rows": None, "action_repeat": 2})]


@pytest.mark.parametrize("env_id,kw", REAL, ids=["car_racing_fast", "car_racing_reference_order",
                                                 "lunar_lander", "bipedal_walker_hardcore"])
def test_real_stack_equals_jax(env_id, kw):
    env = make_env(env_id, base_make="gymnasium:make", **kw)
    ref = jax_make_env(env_id, **kw)
    try:
        same_space(env.observation_space, ref.observation_space)
        same_space(env.action_space, ref.action_space)
        (obs, _), (obs_ref, _) = env.reset(seed=5), ref.reset(seed=5)
        np.testing.assert_array_equal(obs, obs_ref)
        rng = np.random.default_rng(0)
        for _ in range(20):
            a = rng.uniform(-1, 1, env.action_space.shape).astype(np.float32)
            obs, reward, term, trunc, _ = env.step(a)
            obs_ref, reward_ref, term_ref, trunc_ref, _ = ref.step(a)
            assert obs.shape == (64, 64, 3) and obs.dtype == obs_ref.dtype
            np.testing.assert_array_equal(obs, obs_ref)
            assert (reward, term, trunc) == (reward_ref, term_ref, trunc_ref)
            assert type(reward) is type(reward_ref)
            if term or trunc:
                break
    finally:
        env.close()
        ref.close()


def test_pyflyt_missing_is_named():
    with pytest.raises(ImportError, match="PyFlyt"):
        make_env("PyFlyt/QuadX-Hover-v2", base_make="gymnasium:make")


def test_a_real_id_needs_a_maker():
    with pytest.raises(ValueError, match="--env-maker gymnasium:make"):
        make_env("LunarLander-v3")
    with pytest.raises(ValueError, match="module:function"):
        make_env("LunarLander-v3", base_make="gymnasium.make")


def test_default_factory_pickles():
    factory = functools.partial(make_env, "CarRacing-v3", obs_size=(64, 64),
                                base_make="gymnasium:make")
    assert pickle.loads(pickle.dumps(factory)).keywords == factory.keywords
