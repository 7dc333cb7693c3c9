"""Host-side vectorized env farms: ``EnvFarm`` (``dreamer_tpu/envs/vector.py:
32-96``), N envs stepped in one synchronous loop, and ``AsyncEnvFarm``
(``:99-156``), one spawned worker process an env.

Two auto-reset modes, selected by ``next_step`` (``env.next_step_autoreset``):

- SAME-STEP (default, reference parity): the terminal observation is
  discarded; ``step`` returns the reset obs for finished envs together with
  ``done=True``.
- NEXT-STEP: the terminal observation is returned (with ``done=True``); the
  reset happens on the following ``step`` call, which ignores the action and
  returns the reset obs with ``reward=0, done=False, first=True``.

``step`` returns ``(obs, reward, done, first)`` in both modes; in same-step
mode ``first == done``.  ``EnvFarm`` seeds each reset with the next value of
a per-farm counter; ``AsyncEnvFarm`` seeds as gymnasium's ``AsyncVectorEnv``
does (``reset_all`` only, env i with ``seed + i``; auto-resets unseeded).
"""

from __future__ import annotations

import contextlib
import multiprocessing
import os
import time
import traceback
from multiprocessing.connection import wait
from typing import Callable, Sequence, Tuple

import numpy as np

from dreamer_tpu_torch.envs.fake import Box


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


# A worker steps one env on one core: its BLAS and OpenMP pools are started
# with one thread, or N workers would each start a pool as wide as the host
# (numpy's matmul in ResizeObservation spins one up) and oversubscribe it.
_WORKER_THREADS = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
                   "MKL_NUM_THREADS": "1"}


@contextlib.contextmanager
def _environ(values):
    """``os.environ`` with ``values`` set, for the processes started inside."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _worker(env_fn: Callable, conn, next_step: bool) -> None:
    """One env in its own process, serving ``reset``/``step``/``close`` over
    ``conn`` with gymnasium's auto-reset semantics.  Every reply is
    ``("ok", value)`` or ``("error", traceback)``; after an error the worker
    exits."""
    env = None
    try:
        env = env_fn()
        space = env.action_space
        conn.send(("ok", (tuple(space.shape), np.asarray(space.low), np.asarray(space.high))))
        autoreset = False
        while True:
            command, data = conn.recv()
            if command == "reset":
                obs, _ = env.reset(seed=data)
                autoreset = False
                conn.send(("ok", obs))
            elif command == "step":
                if next_step and autoreset:
                    # The step after a done: the action is ignored.
                    obs, _ = env.reset()
                    reward, terminated, truncated = 0.0, False, False
                else:
                    obs, reward, terminated, truncated, _ = env.step(data)
                    if not next_step and (terminated or truncated):
                        obs, _ = env.reset()
                autoreset = bool(terminated or truncated)
                conn.send(("ok", (obs, float(reward), bool(terminated), bool(truncated))))
            elif command == "close":
                conn.send(("ok", None))
                return
            else:
                raise ValueError(f"unknown command {command!r}")
    except EOFError:
        pass
    except Exception:
        try:
            conn.send(("error", traceback.format_exc()))
        except (OSError, ValueError):
            pass
    finally:
        if env is not None:
            env.close()
        conn.close()


class AsyncEnvFarm:
    """``EnvFarm``'s interface over one worker process an env, the workers
    started with ``spawn`` (a fork after CUDA is initialised leaves the child
    without CUDA), each talking to the farm over its own pipe.  What
    ``dreamer_tpu``'s ``AsyncEnvFarm`` gives on gymnasium's ``AsyncVectorEnv``:

    - ``reset_all`` seeds env i with ``seed + i``, then ``seed += num_envs``;
      auto-resets call ``env.reset()`` unseeded;
    - SAME-STEP: a done env returns its reset frame with the terminal step's
      reward and flags, ``first = done``;
    - NEXT-STEP: the step after a done ignores the action and returns the
      reset frame, reward 0, ``done=False``, ``first=True``;
    - ``sample_actions``: one batched ``Box`` of shape (N, action_dim) seeded
      once with the farm's seed.

    Each worker's BLAS and OpenMP pools have one thread.  The env factories
    must pickle (``functools.partial`` of a module-level function, not a
    lambda).  A worker's exception is raised here with its traceback; a
    worker that dies, or does not answer within ``timeout`` seconds, raises
    too.  ``close()`` joins every worker (``workers``, the processes)."""

    # Seconds a worker may take to start or to answer one command.
    timeout = 300.0

    def __init__(self, env_fns: Sequence[Callable], seed: int, next_step: bool = False):
        self.num_envs = len(env_fns)
        self.seed = seed
        self.next_step = next_step
        self._prev_done = np.zeros(self.num_envs, bool)
        ctx = multiprocessing.get_context("spawn")
        self._conns, self.workers = [], []
        self._closed = False
        try:
            with _environ(_WORKER_THREADS):
                for i, fn in enumerate(env_fns):
                    parent, child = ctx.Pipe()
                    proc = ctx.Process(target=_worker, args=(fn, child, next_step),
                                       name=f"env-worker-{i}", daemon=True)
                    proc.start()
                    child.close()
                    self._conns.append(parent)
                    self.workers.append(proc)
            shape, low, high = self._gather()[0]
        except BaseException:
            self._abort()
            raise
        self.action_space = Box(np.broadcast_to(low, (self.num_envs, *shape)),
                                np.broadcast_to(high, (self.num_envs, *shape)),
                                (self.num_envs, *shape), low.dtype)
        self.action_space.seed(seed)

    def _gather(self):
        """Each worker's next reply, in order; raises on a worker's error, a
        dead worker, or ``timeout`` seconds without an answer."""
        if self._closed:
            raise RuntimeError("AsyncEnvFarm is closed")
        out = []
        deadline = time.monotonic() + self.timeout
        for i, (conn, proc) in enumerate(zip(self._conns, self.workers)):
            while not conn.poll():
                left = deadline - time.monotonic()
                if left <= 0:
                    self._abort()
                    raise TimeoutError(f"env worker {i} (pid {proc.pid}) did not answer "
                                       f"within {self.timeout:g} s")
                if proc.sentinel in wait([conn, proc.sentinel], timeout=left) \
                        and not conn.poll():
                    # The sentinel can fire before the child is reapable, when
                    # exitcode is still None: join it first.
                    proc.join(timeout=5)
                    code = proc.exitcode
                    self._abort()
                    raise RuntimeError(f"env worker {i} (pid {proc.pid}) died with exit code "
                                       f"{code}")
            try:
                status, value = conn.recv()
            except EOFError:
                proc.join(timeout=5)
                code = proc.exitcode
                self._abort()
                raise RuntimeError(f"env worker {i} (pid {proc.pid}) died with exit code "
                                   f"{code}") from None
            if status == "error":
                self._abort()
                raise RuntimeError(f"env worker {i} raised:\n{value}")
            out.append(value)
        return out

    def _send(self, command: str, data) -> None:
        if self._closed:
            raise RuntimeError("AsyncEnvFarm is closed")
        for conn, d in zip(self._conns, data):
            conn.send((command, d))

    def reset_all(self) -> np.ndarray:
        """Reset env i with ``seed + i`` and return stacked obs (N, H, W, 3)."""
        self._send("reset", [self.seed + i for i in range(self.num_envs)])
        obs = self._gather()
        self.seed += self.num_envs
        self._prev_done[:] = False
        return np.stack(obs).astype(np.uint8)

    def step(self, actions: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Step all envs.  Returns (obs (N,H,W,3) uint8, reward (N,),
        done (N,), first (N,))."""
        self._send("step", np.asarray(actions))
        obs, rew, term, trunc = zip(*self._gather())
        done = np.logical_or(term, trunc)
        if self.next_step:
            # The envs done last step were reset on this one.
            first = self._prev_done.copy()
            self._prev_done = done.copy()
        else:
            first = done.copy()
        return (np.stack(obs).astype(np.uint8), np.asarray(rew, np.float32), done, first)

    def sample_actions(self) -> np.ndarray:
        return np.asarray(self.action_space.sample())

    def close(self):
        """Ask every worker to close its env and exit, then join it (one that
        does not exit within 10 s is terminated)."""
        if self._closed:
            return
        self._closed = True
        for conn, proc in zip(self._conns, self.workers):
            if proc.is_alive():
                try:
                    conn.send(("close", None))
                except (OSError, ValueError):
                    pass
        for proc in self.workers:
            proc.join(timeout=10)
        self._abort()

    def _abort(self):
        """Terminate every worker still running and join them all."""
        self._closed = True
        for proc in self.workers:
            if proc.is_alive():
                proc.terminate()
        for proc in self.workers:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in self._conns:
            conn.close()
