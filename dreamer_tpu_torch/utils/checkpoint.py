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

Under a data-parallel ``plan`` (``parallel.MeshPlan``) a checkpoint is a
state file and one shard file a rank: rank 0 writes ``ckpt_{step}`` (the
state, the same on every rank, with the world size), and each rank writes
``ckpt_{step}.rank{r}`` (its ring shard and its own generator).  ``LATEST``
moves only after a barrier shows that every rank's files landed: at once
for a synchronous save, at the next save or wait for an asynchronous one
(every rank calls them alike).  A restore refuses a checkpoint of another
world size, naming both; it returns the state merged with this rank's shard.
The checkpoint directory must be one that every rank sees.
"""

from __future__ import annotations

import os
import re
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch

_CKPT = re.compile(r"ckpt_(\d+)")
_SHARD = re.compile(r"ckpt_(\d+)\.rank\d+")


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
    def __init__(self, directory: str, keep_last: int = 3, use_async: bool = False, plan=None):
        self.directory = os.path.abspath(directory)
        self.keep_last = keep_last
        self.use_async = use_async
        self.plan = plan
        # Under a plan: the step whose files are written but not yet pointed at.
        self._uncommitted: Optional[int] = None
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

    def _shard_path(self, step: int) -> str:
        return f"{self._path(step)}.rank{self.plan.rank}"

    def save(self, step: int, tree: Any, shard: Any = None) -> str:
        """Write the checkpoint of ``step``, point ``LATEST`` at it and prune
        all but the newest ``keep_last``; asynchronously under ``use_async``,
        from a snapshot taken before this returns.  Under a plan ``shard`` is
        this rank's part, and only rank 0 writes ``tree``."""
        start = time.perf_counter()
        self.wait_until_finished()
        record = {"step": step}
        self.timings.append(record)
        if self.plan is not None:
            self._uncommitted = step
            if self.plan.rank != 0:
                tree = None
        if not self.use_async:
            self._write(step, tree, shard)
            self._commit()
            record["blocking_s"] = time.perf_counter() - start
            return self._path(step)
        snapshot = self._snapshot(tree, "")
        shard = self._snapshot(shard, "#shard")
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()   # the copies into the pinned buffers
        if self._writer is None:
            self._writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint")
        record["returned_at"] = time.perf_counter()
        record["blocking_s"] = record["returned_at"] - start
        self._pending = self._writer.submit(self._write, step, snapshot, shard, record)
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

    def _write(self, step: int, tree: Any, shard: Any = None,
               record: Optional[Dict[str, float]] = None) -> None:
        start = time.perf_counter()
        if tree is not None:
            atomic_save(tree, self._path(step))
        if self.plan is None:
            self._point(step)
        else:
            atomic_save(shard, self._shard_path(step))
        if record is not None:
            record["landed_at"] = time.perf_counter()
            record["write_s"] = record["landed_at"] - start

    def _point(self, step: int) -> None:
        """``LATEST`` names ``step``; then prune."""
        tmp = os.path.join(self.directory, "LATEST.tmp")
        with open(tmp, "w") as f:
            f.write(str(step))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.directory, "LATEST"))
        self._prune()

    def _commit(self) -> None:
        """Under a plan: once every rank's files of the last save are on
        disk (a barrier), rank 0 points ``LATEST`` at it, and every rank
        waits for that (a second barrier) before it may read ``LATEST``."""
        step, self._uncommitted = self._uncommitted, None
        if step is None:
            return
        self.plan.barrier()
        if self.plan.rank == 0:
            self._point(step)
        self.plan.barrier()

    def wait_until_finished(self) -> None:
        """Block until the last asynchronous save has landed (under a plan,
        on every rank, and ``LATEST`` names it); raise the error its write
        raised, once.  Idempotent."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()
        self._commit()

    def close(self) -> None:
        """Wait for the last save and stop the writer thread."""
        try:
            self.wait_until_finished()
        finally:
            if self._writer is not None:
                self._writer.shutdown(wait=True)
                self._writer = None

    def _prune(self):
        names = os.listdir(self.directory)
        steps = sorted(int(m.group(1)) for name in names if (m := _CKPT.fullmatch(name)))
        old = set(steps[: max(0, len(steps) - self.keep_last)])
        for name in names:
            m = _CKPT.fullmatch(name) or _SHARD.fullmatch(name)
            if m and int(m.group(1)) in old:
                os.remove(os.path.join(self.directory, name))

    def latest_step(self) -> Optional[int]:
        self.wait_until_finished()
        marker = os.path.join(self.directory, "LATEST")
        if not os.path.exists(marker):
            return None
        with open(marker) as f:
            return int(f.read().strip())

    def restore(self, step: int) -> Any:
        self.wait_until_finished()
        tree = load(self._path(step))
        saved = tree.get("world_size") if isinstance(tree, dict) else None
        world = None if self.plan is None else self.plan.world_size
        if saved != world:
            def name(n):
                return "one process without a mesh" if n is None else f"{n} ranks"
            raise ValueError(f"checkpoint {self._path(step)} was written by {name(saved)}, "
                             f"this run is {name(world)}: resume it at the world size that "
                             "wrote it")
        if self.plan is not None:
            tree.update(load(self._shard_path(step)))
        return tree

    def restore_latest(self) -> Optional[Tuple[int, Any]]:
        step = self.latest_step()
        if step is None:
            return None
        return step, self.restore(step)
