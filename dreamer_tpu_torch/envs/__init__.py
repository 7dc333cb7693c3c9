"""Environments of the port, without gymnasium: the fake pixel env, the
wrapper stack of ``dreamer_tpu/envs/adaptors.py`` with its ``make_env``, the
synchronous ``EnvFarm`` and the subprocess ``AsyncEnvFarm``.

``make_env`` builds ``"fake"`` itself and every other id over a base env
from a maker the caller names, ``base_make="module:function"`` with
``gymnasium.make``'s signature (the CLI's ``--env-maker gymnasium:make``),
imported by name in the process that builds the env.  Importing this
package loads numpy and the standard library only, not torch, so that
spawned env workers start quickly."""

from __future__ import annotations

from dreamer_tpu_torch.envs.adaptors import (ActionRepeat, CarRacerAdaptor, CropObservation,
                                             DroneAdaptor, PixelObservation,
                                             RenderSkippingActionRepeat, ResizeObservation,
                                             make_env, missing_maker_message, resize_area)
from dreamer_tpu_torch.envs.fake import Box, FakeEnv
from dreamer_tpu_torch.envs.vector import AsyncEnvFarm, EnvFarm

__all__ = [
    "ActionRepeat",
    "AsyncEnvFarm",
    "Box",
    "CarRacerAdaptor",
    "CropObservation",
    "DroneAdaptor",
    "EnvFarm",
    "FakeEnv",
    "PixelObservation",
    "RenderSkippingActionRepeat",
    "ResizeObservation",
    "make_env",
    "missing_maker_message",
    "resize_area",
]
