"""Resumable checkpoints on ``torch.save`` (the port of
``dreamer_tpu/utils/checkpoint.py``).

A checkpoint is one file, ``ckpt_{step}``, holding one tree of tensors,
numbers, lists and dicts (the orchestrator's ``_checkpoint_tree``: every
module's ``state_dict``, the AdamW states, the generators' states, the
counters and optionally the replay ring).  It is written under a temporary
name, flushed to disk and renamed into place, and only then does the
``LATEST`` pointer (itself replaced the same way) name it, so a save cut off
mid-write leaves the previous checkpoint and pointer whole.  The newest
``keep_last`` checkpoints are kept.  A save is synchronous: it returns
once the file and the pointer are on disk.  Restores read with
``torch.load(weights_only=True)`` onto the CPU; the caller copies the values
into its live tensors, wherever they are.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional, Tuple

import torch

_CKPT = re.compile(r"ckpt_(\d+)")


def atomic_save(obj: Any, path: str) -> None:
    """``torch.save`` to ``path`` through a temporary file that is flushed
    to disk and then renamed over it."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load(path: str) -> Any:
    """A tree written by ``atomic_save``, every tensor on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep_last = keep_last
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}")

    def save(self, step: int, tree: Any) -> str:
        """Write the checkpoint of ``step``, point ``LATEST`` at it and prune
        all but the newest ``keep_last``."""
        path = self._path(step)
        atomic_save(tree, path)
        tmp = os.path.join(self.directory, "LATEST.tmp")
        with open(tmp, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.directory, "LATEST"))
        self._prune()
        return path

    def _prune(self):
        steps = sorted(int(m.group(1)) for name in os.listdir(self.directory)
                       if (m := _CKPT.fullmatch(name)))
        for old in steps[: max(0, len(steps) - self.keep_last)]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        marker = os.path.join(self.directory, "LATEST")
        if not os.path.exists(marker):
            return None
        with open(marker) as f:
            return int(f.read().strip())

    def restore(self, step: int) -> Any:
        return load(self._path(step))

    def restore_latest(self) -> Optional[Tuple[int, Any]]:
        step = self.latest_step()
        if step is None:
            return None
        return step, self.restore(step)
