"""Environments of the port: the fake pixel env and the synchronous farm.

The GPU machine has no gymnasium, so ``make_env`` builds only the fake env;
a real environment reaches the orchestrator as its ``env_factory`` argument
(any object with gymnasium's ``reset``/``step`` tuples and an
``action_space`` with ``seed`` and ``sample``)."""

from __future__ import annotations

from typing import Optional, Tuple

from dreamer_tpu_torch.envs.fake import FakeEnv
from dreamer_tpu_torch.envs.vector import EnvFarm


def make_env(env_id: str, obs_size: Tuple[int, int] = (64, 64), action_repeat: int = 4,
             crop_rows: Optional[int] = 84, max_episode_steps: Optional[int] = None):
    """``"fake"`` gives ``FakeEnv`` (``dreamer_tpu/envs/adaptors.py:218-222``);
    the other arguments shape real envs, which the port does not build."""
    if env_id == "fake":
        return FakeEnv(obs_size=obs_size, episode_len=max_episode_steps or 100)
    raise ValueError(
        f"make_env: the port builds only env_id 'fake', not {env_id!r}: a real "
        "environment reaches the port as the env_factory argument of "
        "orchestrator.Dreamer, since the GPU machine has no gymnasium")


__all__ = ["EnvFarm", "FakeEnv", "make_env"]
