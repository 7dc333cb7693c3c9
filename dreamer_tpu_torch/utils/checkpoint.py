"""Resumable checkpoints on ``torch.save`` (the port of
``dreamer_tpu/utils/checkpoint.py``).

A checkpoint is one file, ``ckpt_{step}``, holding one tree of tensors,
numbers, lists and dicts (the orchestrator's ``_checkpoint_tree``: every
module's ``state_dict``, the AdamW states, the generators' states, the
counters and optionally the replay ring).  It is written under a temporary
name, flushed to disk and renamed into place, and only then does the
``LATEST`` pointer (itself replaced the same way) name it, so a save cut off
mid-write leaves the previous checkpoint and pointer whole.  The newest
``keep_last`` checkpoints are kept.  Restores read with
``torch.load(weights_only=True)`` onto the CPU; the caller copies the values
into its live tensors, wherever they are.

A synchronous save returns once the file and the pointer are on disk.  An
asynchronous one (``use_async``, ``runtime.async_checkpoint``; JAX's orbax
``AsyncCheckpointer``) waits for the previous save to land, copies every
tensor of the tree to host memory before it returns (the training state and
the ring are written in place by the next update and round, so the write
must not read them), and leaves the write, the pointer and the pruning, in
that order, to one writer thread.  A CUDA tensor is copied into a pinned
host buffer kept for its place in the tree and reused by every later save;
a CPU tensor is cloned.  ``wait_until_finished`` blocks until the last save
has landed and raises what its write raised; ``save``, ``latest_step`` and
``restore_latest`` call it first.
"""

from __future__ import annotations

import os
import re
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

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
    def __init__(self, directory: str, keep_last: int = 3, use_async: bool = False):
        self.directory = os.path.abspath(directory)
        self.keep_last = keep_last
        self.use_async = use_async
        os.makedirs(self.directory, exist_ok=True)
        self._writer: Optional[ThreadPoolExecutor] = None
        self._pending: Optional[Future] = None
        # Pinned host buffers of the CUDA tensors, by their place in the tree.
        self._staging: Dict[str, torch.Tensor] = {}
        # One record a save: its step, the seconds save() blocked, and (for an
        # asynchronous save, once it has landed) the seconds of the write and
        # the perf_counter times at which save() returned and the file landed.
        self.timings: List[Dict[str, float]] = []

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}")

    def save(self, step: int, tree: Any) -> str:
        """Write the checkpoint of ``step``, point ``LATEST`` at it and prune
        all but the newest ``keep_last``; asynchronously under ``use_async``,
        from a snapshot taken before this returns."""
        start = time.perf_counter()
        self.wait_until_finished()
        record = {"step": step}
        self.timings.append(record)
        if not self.use_async:
            self._write(step, tree)
            record["blocking_s"] = time.perf_counter() - start
            return self._path(step)
        snapshot = self._snapshot(tree, "")
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()   # the copies into the pinned buffers
        if self._writer is None:
            self._writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint")
        record["returned_at"] = time.perf_counter()
        record["blocking_s"] = record["returned_at"] - start
        self._pending = self._writer.submit(self._write, step, snapshot, record)
        return self._path(step)

    def _snapshot(self, tree: Any, where: str) -> Any:
        """``tree`` with every tensor copied to host memory."""
        if isinstance(tree, torch.Tensor):
            t = tree.detach()
            if not t.is_cuda:
                return t.clone()
            buf = self._staging.get(where)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                self._staging[where] = buf
            buf.copy_(t, non_blocking=True)
            return buf
        if isinstance(tree, dict):
            return {k: self._snapshot(v, f"{where}/{k}") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._snapshot(v, f"{where}/{i}") for i, v in enumerate(tree))
        return tree

    def _write(self, step: int, tree: Any, record: Optional[Dict[str, float]] = None) -> None:
        start = time.perf_counter()
        atomic_save(tree, self._path(step))
        tmp = os.path.join(self.directory, "LATEST.tmp")
        with open(tmp, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.directory, "LATEST"))
        self._prune()
        if record is not None:
            record["landed_at"] = time.perf_counter()
            record["write_s"] = record["landed_at"] - start

    def wait_until_finished(self) -> None:
        """Block until the last asynchronous save has landed; raise the error
        its write raised, once.  Idempotent."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def close(self) -> None:
        """Wait for the last save and stop the writer thread."""
        try:
            self.wait_until_finished()
        finally:
            if self._writer is not None:
                self._writer.shutdown(wait=True)
                self._writer = None

    def _prune(self):
        steps = sorted(int(m.group(1)) for name in os.listdir(self.directory)
                       if (m := _CKPT.fullmatch(name)))
        for old in steps[: max(0, len(steps) - self.keep_last)]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        marker = os.path.join(self.directory, "LATEST")
        if not os.path.exists(marker):
            return None
        with open(marker) as f:
            return int(f.read().strip())

    def restore(self, step: int) -> Any:
        self.wait_until_finished()
        return load(self._path(step))

    def restore_latest(self) -> Optional[Tuple[int, Any]]:
        step = self.latest_step()
        if step is None:
            return None
        return step, self.restore(step)
