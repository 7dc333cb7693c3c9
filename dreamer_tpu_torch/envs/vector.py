"""Host-side vectorized env farm (``dreamer_tpu/envs/vector.py:32-96``): N
envs stepped in one synchronous loop.

Two auto-reset modes, selected by ``next_step`` (``env.next_step_autoreset``):

- SAME-STEP (default, reference parity): the terminal observation is
  discarded; ``step`` returns the reset obs for finished envs together with
  ``done=True``.
- NEXT-STEP: the terminal observation is returned (with ``done=True``); the
  reset happens on the following ``step`` call, which ignores the action and
  returns the reset obs with ``reward=0, done=False, first=True``.

``step`` returns ``(obs, reward, done, first)`` in both modes; in same-step
mode ``first == done``.  Each reset consumes the next seed from a
monotonically increasing per-farm counter.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np


class EnvFarm:
    def __init__(self, env_fns: Sequence[Callable], seed: int, next_step: bool = False):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        self.seed = seed
        self.next_step = next_step
        self._needs_reset = np.zeros(self.num_envs, bool)
        # Seeded action spaces make random-policy rollouts reproducible.
        for i, env in enumerate(self.envs):
            env.action_space.seed(seed + i)
        self._action_space = self.envs[0].action_space

    def reset_all(self) -> np.ndarray:
        """Reset every env (seed, seed+1, ...) and return stacked obs (N, H, W, 3)."""
        obs = []
        self._needs_reset[:] = False
        for env in self.envs:
            o, _ = env.reset(seed=self.seed)
            self.seed += 1
            obs.append(o)
        return np.stack(obs).astype(np.uint8)

    def step(self, actions: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Step all envs.  Returns (obs (N,H,W,3) uint8, reward (N,),
        done (N,), first (N,))."""
        obs_out, rew_out, done_out, first_out = [], [], [], []
        for i, (env, action) in enumerate(zip(self.envs, actions)):
            if self.next_step and self._needs_reset[i]:
                # Delayed reset step: the action is ignored.
                o, _ = env.reset(seed=self.seed)
                self.seed += 1
                self._needs_reset[i] = False
                r, done, first = 0.0, False, True
            else:
                o, r, term, trunc, _ = env.step(np.asarray(action))
                done = bool(term or trunc)
                first = False
                if done:
                    if self.next_step:
                        self._needs_reset[i] = True
                    else:
                        o, _ = env.reset(seed=self.seed)
                        self.seed += 1
                        first = True
            obs_out.append(o)
            rew_out.append(r)
            done_out.append(done)
            first_out.append(first)
        return (np.stack(obs_out).astype(np.uint8),
                np.asarray(rew_out, np.float32),
                np.asarray(done_out, bool),
                np.asarray(first_out, bool))

    def sample_actions(self) -> np.ndarray:
        return np.stack([self._action_space.sample() for _ in range(self.num_envs)])

    def close(self):
        for env in self.envs:
            env.close()
