"""The deterministic fake pixel environment of ``dreamer_tpu/envs/fake.py``
as a plain numpy class (no gymnasium): the same frames, rewards, truncation
and seeding, and an action space with gymnasium ``Box``'s ``seed`` and
``sample`` streams.

Dynamics: a dot moves on a 2D plane under the first two dims of the action;
the observation renders the dot as a bright square on a gradient background,
with a faint time signal in the blue channel.  Reward is higher near the
centre.  Episodes truncate after ``episode_len`` steps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class Box:
    """A bounded box (``low`` and ``high`` scalars or arrays broadcast to
    ``shape``).  ``seed(s)`` then ``sample()`` gives what gymnasium's ``Box``
    gives for the same seed: its generator is
    ``np.random.Generator(PCG64(SeedSequence(s)))`` and a sample one uniform
    draw over every entry in C order, floored for an integer dtype, cast to
    ``dtype``.  A batch of N boxes is the box of shape ``(N, *shape)``."""

    def __init__(self, low, high, shape: Tuple[int, ...], dtype=np.float32):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape).copy()
        self._rng = np.random.default_rng()

    def seed(self, seed: Optional[int] = None):
        self._rng = np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))
        return seed

    def sample(self) -> np.ndarray:
        if self.dtype.kind == "f":
            return self._rng.uniform(self.low, self.high, size=self.shape).astype(self.dtype)
        high = self.high.astype(np.int64) + 1
        return np.floor(self._rng.uniform(self.low, high, size=self.shape)).astype(self.dtype)


class FakeEnv:
    def __init__(self, obs_size: Tuple[int, int] = (64, 64), action_dim: int = 3,
                 episode_len: int = 100):
        self.obs_size = obs_size
        self.action_dim = action_dim
        self.episode_len = episode_len
        self.observation_space = Box(0, 255, (obs_size[0], obs_size[1], 3), np.uint8)
        self.action_space = Box(-1.0, 1.0, (action_dim,))
        self._pos = np.zeros(2, np.float32)
        self._t = 0
        self._rng = np.random.RandomState(0)

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._pos = self._rng.uniform(-0.8, 0.8, size=2).astype(np.float32)
        self._t = 0
        return self._render_obs(), {}

    def step(self, action):
        a = np.asarray(action, np.float32)[:2]
        self._pos = np.clip(self._pos + 0.1 * a, -1.0, 1.0)
        self._t += 1
        reward = float(1.0 - np.linalg.norm(self._pos))
        terminated = False
        truncated = self._t >= self.episode_len
        return self._render_obs(), reward, terminated, truncated, {}

    @property
    def unwrapped(self) -> "FakeEnv":
        return self

    def render(self) -> np.ndarray:
        """The current frame, (H, W, 3) uint8."""
        return self._render_obs()

    def close(self):
        pass

    def _render_obs(self) -> np.ndarray:
        h, w = self.obs_size
        ramp = np.linspace(0, 80, w, dtype=np.float32)
        obs = np.broadcast_to(ramp[None, :, None], (h, w, 3)).copy()
        cy = int((self._pos[1] + 1) / 2 * (h - 9))
        cx = int((self._pos[0] + 1) / 2 * (w - 9))
        obs[cy:cy + 8, cx:cx + 8, :] = 255.0
        obs[:, :, 2] += self._t % 50
        return np.clip(obs, 0, 255).astype(np.uint8)
