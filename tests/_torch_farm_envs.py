"""Fake envs that fail inside ``AsyncEnvFarm``'s spawned workers, for
``test_torch_async_farm.py``: module-level, so that a ``functools.partial``
of them pickles, and importing nothing of JAX, so that a worker starts
quickly."""

import os
import time

from dreamer_tpu_torch.envs import FakeEnv


class RaisingEnv(FakeEnv):
    """Raises on its ``fail_at``-th step."""

    def __init__(self, fail_at: int = 2, **kwargs):
        super().__init__(**kwargs)
        self.fail_at = fail_at
        self.steps = 0

    def step(self, action):
        self.steps += 1
        if self.steps == self.fail_at:
            raise FloatingPointError(f"the physics blew up at step {self.steps}")
        return super().step(action)


class DyingEnv(FakeEnv):
    """Its process exits without a word on the first step."""

    def step(self, action):
        os._exit(3)


class HangingEnv(FakeEnv):
    """Never answers its first step."""

    def step(self, action):
        time.sleep(3600)


def broken_factory():
    raise ImportError("no module named 'box2d'")


class ThreadsEnv(FakeEnv):
    """Its reward reports the worker's BLAS and OpenMP thread settings:
    OPENBLAS_NUM_THREADS + 10 x OMP_NUM_THREADS (0 where unset)."""

    def step(self, action):
        obs, _, terminated, truncated, info = super().step(action)
        n = {k: float(os.environ.get(k, "0")) for k in ("OPENBLAS_NUM_THREADS",
                                                         "OMP_NUM_THREADS")}
        return obs, n["OPENBLAS_NUM_THREADS"] + 10 * n["OMP_NUM_THREADS"], terminated, \
            truncated, info
