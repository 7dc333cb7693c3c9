"""The wrapper stack of ``dreamer_tpu/envs/adaptors.py`` without gymnasium,
and ``make_env``, which stacks it on a base env built by a maker the caller
names (``base_make="module:function"``, ``gymnasium.make``'s signature):

    CarRacing:  RenderSkippingActionRepeat -> Crop(84 rows) -> Resize(64x64)
                -> CarRacerAdaptor   (or Crop -> Resize -> Adaptor -> ActionRepeat)
    LunarLander, BipedalWalker:  ActionRepeat -> PixelObservation -> Resize
    PyFlyt:     ActionRepeat -> PixelObservation -> Resize -> DroneAdaptor

The wrappers are plain classes over any env with gymnasium's
``reset(seed=, options=)`` and ``step`` five-tuples, ``render()``,
``close()`` and spaces with ``.shape``; each has the JAX class's name,
arithmetic and Python types, so that frames, rewards and actions are equal
bit for bit.  ``ResizeObservation`` is ``cv2.resize(..., INTER_AREA)``
exactly, in numpy (``resize_area``): the JAX class uses OpenCV where it is
installed, and its numpy fallback is another function.

The maker is imported by name inside the process that builds the env, so a
``functools.partial(make_env, ...)`` pickles for spawned workers and no
module of the port imports gymnasium.  Observations stay HWC uint8.
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
from typing import Callable, Optional

import numpy as np

from dreamer_tpu_torch.envs.fake import Box, FakeEnv

# The drone's simulator registers its ids with gymnasium when its gym_envs
# module is imported.
_PYFLYT = "PyFlyt"


class Wrapper:
    """``gymnasium.Wrapper``'s delegation: ``reset``, ``step``, ``render``,
    ``close``, ``unwrapped`` and the spaces go to the wrapped env unless the
    wrapper sets its own; other public attributes fall through."""

    def __init__(self, env):
        self.env = env
        self._action_space = None
        self._observation_space = None

    @property
    def action_space(self):
        return self.env.action_space if self._action_space is None else self._action_space

    @action_space.setter
    def action_space(self, space):
        self._action_space = space

    @property
    def observation_space(self):
        return (self.env.observation_space if self._observation_space is None
                else self._observation_space)

    @observation_space.setter
    def observation_space(self, space):
        self._observation_space = space

    @property
    def unwrapped(self):
        return getattr(self.env, "unwrapped", self.env)

    def reset(self, *, seed: Optional[int] = None, options=None):
        return self.env.reset(seed=seed, options=options)

    def step(self, action):
        return self.env.step(action)

    def render(self):
        return self.env.render()

    def close(self):
        return self.env.close()

    def __getattr__(self, name):
        env = self.__dict__.get("env")
        if name.startswith("_") or env is None:
            raise AttributeError(name)
        return getattr(env, name)


class ActionWrapper(Wrapper):
    def step(self, action):
        return self.env.step(self.action(action))

    def action(self, action):
        raise NotImplementedError


class ObservationWrapper(Wrapper):
    def reset(self, *, seed: Optional[int] = None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return self.observation(obs), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self.observation(obs), reward, terminated, truncated, info

    def observation(self, obs):
        raise NotImplementedError


class CarRacerAdaptor(ActionWrapper):
    """[-1,1]^3 agent actions -> CarRacing (steer, gas, brake): gas and brake
    rescaled from [-1,1] to [0,1], float64 (``adaptors.py:18-30``)."""

    def __init__(self, env):
        super().__init__(env)
        self.action_space = Box(-1, 1, (3,))

    def action(self, action):
        steering = action[0]
        gas = (action[1] + 1) / 2
        brake = (action[2] + 1) / 2
        return np.array([steering, gas, brake], dtype=np.float64)


class DroneAdaptor(ActionWrapper):
    """[-1,1]^4 -> PyFlyt (vx, vy, vz, yaw-rate), float32 (``:33-42``)."""

    def __init__(self, env):
        super().__init__(env)
        self.action_space = Box(-1, 1, (4,))

    def action(self, action):
        return np.array([action[0], action[1], action[2], action[3]], dtype=np.float32)


class CropObservation(ObservationWrapper):
    """The top ``rows`` rows of the frame: CarRacing's 96x96 without its
    dashboard (``:45-57``)."""

    def __init__(self, env, rows: int = 84):
        super().__init__(env)
        h, w, c = env.observation_space.shape
        self.rows = rows
        self.observation_space = Box(0, 255, (rows, w, c), np.uint8)

    def observation(self, obs):
        return obs[: self.rows, :, :]


class ResizeObservation(ObservationWrapper):
    """Resize to (size, size) uint8 as ``cv2.INTER_AREA`` does (``:60-84``
    with OpenCV): ``resize_area``."""

    def __init__(self, env, size):
        super().__init__(env)
        self.size = tuple(size)
        c = env.observation_space.shape[2]
        self.observation_space = Box(0, 255, (self.size[0], self.size[1], c), np.uint8)

    def observation(self, obs):
        return resize_area(obs, self.size)


def resize_area(obs: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(obs, (size[1], size[0]), interpolation=cv2.INTER_AREA)``
    of an (H, W, C) uint8 frame, bit for bit.  OpenCV takes one of three
    routes, and so does this:

    - every axis shrinks by a whole factor: each output pixel is its box's
      integer sum times the float32 reciprocal of the box's area, rounded
      half to even; a 2 x 2 box rounds ``(sum + 2) >> 2``, half up;
    - every axis shrinks, some by a fraction: per axis a weight matrix whose
      (i, j) entry is source pixel j's share of output pixel i's box
      ``[i s, (i + 1) s)`` over the box's width (``_area_weights``), then
      ``W_y x W_x^T`` rounded half to even;
    - an axis grows: OpenCV's linear resize with area-mode coefficients, in
      its 11-bit fixed point (``_resize_area_linear``).
    """
    x = np.asarray(obs)
    h, w = x.shape[:2]
    oh, ow = int(size[0]), int(size[1])
    if (oh, ow) == (h, w):
        return x.astype(np.uint8)
    sy, sx = 1.0 / (oh / h), 1.0 / (ow / w)
    if sy < 1 or sx < 1:
        return _resize_area_linear(x, oh, ow)
    ky, kx = int(round(sy)), int(round(sx))
    if abs(sy - ky) < np.finfo(np.float64).eps and abs(sx - kx) < np.finfo(np.float64).eps:
        s = x.reshape(oh, ky, ow, kx, -1).sum(axis=(1, 3), dtype=np.int64)
        if ky == kx == 2:
            return ((s + 2) >> 2).astype(np.uint8)
        out = np.rint(s.astype(np.float32) * np.float32(1.0 / (ky * kx)))
        return np.clip(out, 0, 255).astype(np.uint8)
    wy, wx = _area_weights(h, oh), _area_weights(w, ow)
    c = x.shape[2]
    rows = (wy @ x.reshape(h, w * c).astype(np.float64)).reshape(oh, w, c)
    out = (rows.transpose(0, 2, 1) @ wx.T).transpose(0, 2, 1)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in): OpenCV's ``computeResizeAreaTab`` as a matrix (slivers
    under 1e-3 of a pixel dropped, the last box clipped to the frame)."""
    scale = 1.0 / (n_out / n_in)
    w = np.zeros((n_out, n_in))
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s2 = min(int(np.floor(f2)), n_in - 1)
        s1 = min(int(np.ceil(f1)), s2)
        if s1 - f1 > 1e-3:
            w[d, s1 - 1] = (s1 - f1) / cell
        w[d, s1:s2] = 1.0 / cell
        if f2 - s2 > 1e-3:
            w[d, s2] = min(min(f2 - s2, 1.0), cell) / cell
    w.setflags(write=False)
    return w


@functools.lru_cache(maxsize=None)
def _linear_taps(n_in: int, n_out: int):
    """Per output index its first source index and the two 11-bit weights of
    OpenCV's area-mode linear resize."""
    inv = n_out / n_in
    scale = 1.0 / inv
    src = np.zeros(n_out, np.int64)
    coef = np.zeros((n_out, 2), np.int64)
    for d in range(n_out):
        s = int(np.floor(d * scale))
        f = np.float32((d + 1) - (s + 1) * inv)
        f = np.float32(0) if f <= 0 else np.float32(f - np.floor(f))
        if s >= n_in - 1:
            s, f = n_in - 1, np.float32(0)
        src[d] = s
        coef[d] = (np.rint((np.float32(1) - f) * np.float32(2048)),
                   np.rint(f * np.float32(2048)))
    src.setflags(write=False)
    coef.setflags(write=False)
    return src, coef


def _resize_area_linear(x: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """OpenCV's ``INTER_AREA`` where an axis grows: a horizontal pass in
    integers, then the vertical pass in its vectorised fixed-point form
    ``((b0 (S0 >> 4)) >> 16) + ((b1 (S1 >> 4)) >> 16) + 2) >> 2``."""
    h, w = x.shape[:2]
    xs, xc = _linear_taps(w, ow)
    ys, yc = _linear_taps(h, oh)
    v = x.astype(np.int64)
    rows = v[:, xs] * xc[None, :, 0, None] + v[:, np.minimum(xs + 1, w - 1)] * xc[None, :, 1, None]
    s0, s1 = rows[ys], rows[np.minimum(ys + 1, h - 1)]
    b0, b1 = yc[:, 0, None, None], yc[:, 1, None, None]
    out = (((b0 * (s0 >> 4)) >> 16) + ((b1 * (s1 >> 4)) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


class PixelObservation(ObservationWrapper):
    """The rendered RGB frame in place of a state-vector observation, for
    learning LunarLander, BipedalWalker and PyFlyt from pixels (``:110-132``).
    The env must render ``"rgb_array"``; RGBA renders are sliced to RGB.
    Wrap it outside ActionRepeat, so that one frame an agent step renders.
    Construction resets the env with seed 0 and renders once, for the shape."""

    def __init__(self, env):
        super().__init__(env)
        frame = self._frame_shape(env)
        self.observation_space = Box(0, 255, frame, np.uint8)

    @staticmethod
    def _frame_shape(env):
        env.reset(seed=0)
        frame = np.asarray(env.render())
        return frame.shape[:2] + (3,)

    def observation(self, obs):
        return np.asarray(self.env.render(), dtype=np.uint8)[..., :3]


class RenderSkippingActionRepeat(Wrapper):
    """Action repeat innermost, on the raw env, for envs that render their
    pixel observation inside ``step()`` (CarRacing-v3: ``self.state =
    self._render("state_pixels")``), with ``_render`` stubbed for the first
    repeat - 1 frames and restored for the observed one (``:134-182``).
    CarRacing's rewards and termination are physics only, so the trajectory
    is ``ActionRepeat``'s at about 1/repeat of the render cost; an episode
    that ends early re-renders its last frame.  Rewards are summed as
    ``float``."""

    def __init__(self, env, repeat: int = 4):
        super().__init__(env)
        self.repeat = repeat
        # CarRacing sets ``.state`` on its first reset; only ``._render`` is
        # there at construction.
        if not hasattr(env.unwrapped, "_render"):
            raise TypeError("RenderSkippingActionRepeat needs a raw env that renders its "
                            "observation via ._render into .state (e.g. CarRacing); use "
                            "ActionRepeat otherwise")

    def step(self, action):
        raw = self.env.unwrapped
        real_render = raw._render
        total_reward = 0.0
        done = truncated = False
        obs, info = None, {}
        rendered = False
        try:
            for i in range(self.repeat):
                last = i == self.repeat - 1
                raw._render = real_render if last else (lambda mode: raw.state)
                obs, reward, d, t, info = self.env.step(action)
                total_reward += float(reward)
                done, truncated = done or d, truncated or t
                rendered = last
                if done or truncated:
                    break
        finally:
            raw._render = real_render
        if not rendered:
            obs = raw.state = real_render("state_pixels")
        return obs, total_reward, done, truncated, info


class ActionRepeat(Wrapper):
    """Repeat each action ``repeat`` times, summing rewards with ``+=`` on the
    env's own reward type, stopping at an episode's end (``:184-205``)."""

    def __init__(self, env, repeat: int = 4):
        super().__init__(env)
        self.repeat = repeat

    def step(self, action):
        total_reward = 0.0
        done = truncated = False
        last_obs, last_info = None, {}
        for _ in range(self.repeat):
            obs, reward, d, t, info = self.env.step(action)
            total_reward += reward
            done = done or d
            truncated = truncated or t
            last_obs, last_info = obs, info
            if done or truncated:
                break
        return last_obs, total_reward, done, truncated, last_info


def missing_maker_message(env_id: str) -> str:
    return (f"env_id {env_id!r} needs a base-env maker, a 'module:function' with "
            "gymnasium.make's signature: pass --env-maker gymnasium:make to "
            "python -m dreamer_tpu_torch.cli.train (base_make= to make_env, env_maker= to "
            "Dreamer, or a whole env_factory) on a machine with gymnasium; only 'fake' needs "
            "none")


def resolve_maker(base_make: str) -> Callable:
    """The function a ``"module:function"`` string names, imported now."""
    module, sep, name = base_make.partition(":")
    if not (sep and module and name):
        raise ValueError(f"base_make {base_make!r} is not 'module:function'")
    return getattr(importlib.import_module(module), name)


def make_env(env_id: str, obs_size=(64, 64), action_repeat: int = 4,
             crop_rows: Optional[int] = 84, render_mode: Optional[str] = None,
             max_episode_steps: Optional[int] = None, fast_repeat: bool = True,
             base_make: Optional[str] = None):
    """A pixel env with the reference's wrapper stack, in the order of
    ``dreamer_tpu/envs/adaptors.py:207-272``, over ``base_make(env_id,
    render_mode=, max_episode_steps=, **kwargs)``.

    ``"fake"`` is ``FakeEnv`` and needs no maker; every other id raises
    ``ValueError`` without one.  ``fast_repeat=False`` gives CarRacing the
    reference's literal order instead of the render-skipping fast path.
    """
    if env_id == "fake":
        return FakeEnv(obs_size=obs_size, episode_len=max_episode_steps or 100)

    if env_id.startswith(_PYFLYT):
        if importlib.util.find_spec(_PYFLYT) is None:
            raise ImportError(
                "PyFlyt is not installed; the drone configs need the optional "
                "PyFlyt dependency (pip install PyFlyt)")
    if base_make is None:
        raise ValueError(f"make_env: {missing_maker_message(env_id)}")
    make = resolve_maker(base_make)

    if env_id.startswith(_PYFLYT):
        importlib.import_module(_PYFLYT + ".gym_envs")
        env = make(env_id, render_mode=render_mode or "rgb_array",
                   max_episode_steps=max_episode_steps)
        # ActionRepeat inside PixelObservation: one render an agent step.
        env = ActionRepeat(env, repeat=action_repeat)
        env = PixelObservation(env)
        env = ResizeObservation(env, obs_size)
        return DroneAdaptor(env)

    kwargs = {}
    # State-vector Box2D envs learned from pixels: render to rgb_array and
    # put the frame in place of the state observation.
    pixels_from_render = env_id.startswith(("LunarLander", "BipedalWalker"))
    if env_id.startswith(("CarRacing", "LunarLander")):
        kwargs["continuous"] = True
    if pixels_from_render and render_mode is None:
        render_mode = "rgb_array"
    env = make(env_id, render_mode=render_mode, max_episode_steps=max_episode_steps, **kwargs)
    if pixels_from_render:
        # ActionRepeat first, so that intermediate frames are never rendered.
        env = ActionRepeat(env, repeat=action_repeat)
        env = PixelObservation(env)
        return ResizeObservation(env, obs_size)
    if env_id.startswith("CarRacing") and fast_repeat and render_mode is None:
        # The repeat innermost with intermediate renders skipped; the
        # observation wrappers then run once an agent step.
        env = RenderSkippingActionRepeat(env, repeat=action_repeat)
        if crop_rows:
            env = CropObservation(env, crop_rows)
        env = ResizeObservation(env, obs_size)
        return CarRacerAdaptor(env)
    if crop_rows:
        env = CropObservation(env, crop_rows)
    env = ResizeObservation(env, obs_size)
    if env_id.startswith("CarRacing"):
        env = CarRacerAdaptor(env)
    return ActionRepeat(env, repeat=action_repeat)
