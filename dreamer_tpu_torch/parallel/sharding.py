"""How the learner lays out over the data axis, and the collectives it needs
(the port of ``dreamer_tpu/parallel/sharding.py``'s data axis).

Under GSPMD the JAX learner is one program over the global batch, and XLA
inserts the reductions.  Here each rank runs the update on its block of the
batch's rows, and ``MeshPlan`` supplies what makes the ranks' updates one
update of the whole batch (``tests/test_torch_parallel.py`` holds an S-rank
update equal to one process's update with ``n_shards=S``):

- ``reduce_update``: one flat all-reduce (mean) of an update's gradients,
  before the global-norm clip, carrying the non-finite flag beside them
  (any rank non-finite, every rank skips);
- ``sum``: the world-model loss's batch statistics, the mask count of its
  denominator and the KL means that free bits clamp after the mean;
- ``gather``: the lambda-returns whose P95 - P05 scales the advantage;
- ``mean_metrics``: the logged metrics, as global means;
- ``broadcast`` and ``barrier``: rank 0's stop flag and eval reward, and the
  checkpoint's commit.

The layout: rank r of S owns env block r of the global farm and row block r
of every batch.  Without a process group (one rank) every collective is the
identity.  Each collective waits for the device before and after it, and its
seconds add up in ``seconds`` (``calls`` counts them).
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from dreamer_tpu_torch.parallel.mesh import Mesh

Tensor = torch.Tensor


def block(n: int, parts: int, index: int, what: str) -> slice:
    """Block ``index`` of ``n`` items cut into ``parts`` equal blocks."""
    if n % parts:
        raise ValueError(f"{what} {n} does not divide into {parts} data shards")
    per = n // parts
    return slice(index * per, (index + 1) * per)


class MeshPlan:
    def __init__(self, mesh: Mesh, device):
        self.mesh = mesh
        self.n_data = mesh.n_data
        self.rank = mesh.rank
        self.world_size = mesh.world_size
        self.device = torch.device(device)
        self.active = dist.is_initialized()
        # Host values (the stop flag, the eval reward) travel on the CPU
        # under gloo and on the card under nccl.
        self.host_device = (self.device if self.active and dist.get_backend() == "nccl"
                            else torch.device("cpu"))
        self.seconds = 0.0
        self.calls = 0

    # ------------------------------------------------------------------ #
    # Layout
    # ------------------------------------------------------------------ #

    def env_block(self, num_envs: int) -> slice:
        """This rank's envs of the global farm."""
        return block(num_envs, self.n_data, self.rank, "the global env count")

    def row_block(self, batch_size: int) -> slice:
        """This rank's rows of a global batch."""
        return block(batch_size, self.n_data, self.rank, "train.batch_size")

    # ------------------------------------------------------------------ #
    # Collectives
    # ------------------------------------------------------------------ #

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, collective, *args, **kwargs) -> None:
        self._sync()
        start = time.perf_counter()
        collective(*args, **kwargs)
        self._sync()
        self.seconds += time.perf_counter() - start
        self.calls += 1

    def sum(self, x: Tensor) -> Tensor:
        """The sum of ``x`` over the ranks (a new tensor)."""
        out = x.detach().clone()
        if self.active:
            self._run(dist.all_reduce, out, op=dist.ReduceOp.SUM)
        return out

    def reduce_update(self, grads: Sequence[Tensor], finite: Tensor
                      ) -> Tuple[List[Tensor], Tensor]:
        """The gradients averaged over the ranks and the update's finite flag
        true only where it is true on every rank: one flat all-reduce."""
        if not self.active:
            return list(grads), finite
        flat = torch.cat([g.reshape(-1).float() for g in grads]
                         + [(~finite).float().reshape(1)])
        self._run(dist.all_reduce, flat, op=dist.ReduceOp.SUM)
        out, i = [], 0
        for g in grads:
            out.append((flat[i:i + g.numel()] / self.world_size).view_as(g).to(g.dtype))
            i += g.numel()
        return out, flat[-1] == 0

    def gather(self, x: Tensor) -> Tensor:
        """Every rank's ``x``, in rank order along dim 0."""
        if not self.active:
            return x
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world_size)]
        self._run(dist.all_gather, parts, x)
        return torch.cat(parts)

    def mean_metrics(self, metrics: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """Each metric's mean over the ranks: one flat all-reduce."""
        if not self.active:
            return metrics
        flat = torch.cat([v.detach().float().reshape(-1) for v in metrics.values()])
        self._run(dist.all_reduce, flat, op=dist.ReduceOp.SUM)
        flat /= self.world_size
        out, i = {}, 0
        for k, v in metrics.items():
            out[k] = flat[i:i + v.numel()].view(v.shape)
            i += v.numel()
        return out

    def broadcast(self, value: float) -> float:
        """Rank 0's ``value`` on every rank."""
        if not self.active:
            return value
        t = torch.tensor([float(value)], dtype=torch.float64, device=self.host_device)
        self._run(dist.broadcast, t, src=0)
        return float(t.item())

    def barrier(self) -> None:
        if self.active:
            if self.host_device.type == "cuda":
                self._run(dist.barrier, device_ids=[self.host_device.index or 0])
            else:
                self._run(dist.barrier)
