"""How the learner lays out over the (data, model) mesh, and the collectives
it needs (the port of ``dreamer_tpu/parallel/sharding.py``).

Under GSPMD the JAX learner is one program over the global batch, and XLA
inserts the reductions.  Here each rank runs the update on its data block of
the batch's rows, and ``MeshPlan`` supplies what makes the ranks' updates one
update of the whole batch (``tests/test_torch_parallel.py`` and
``tests/test_torch_model_axis.py`` hold an ``[n, m]`` update equal to one
process's update with ``n_shards=n``):

- ``reduce_update``: one flat all-reduce (mean over the whole world) of an
  update's gradients, before the global-norm clip, carrying the non-finite
  flag beside them (any rank non-finite, every rank skips).  A model group's
  m ranks hold the same rows, so their m copies of a data block's gradient
  average out, and every rank gets the same reduced gradient bit for bit;
- ``sum``: the world-model loss's batch statistics, the mask count of its
  denominator and the KL means that free bits clamp after the mean (over
  the world: the loss scales by the world size on both sides);
- ``gather``: the lambda-returns whose P95 - P05 scales the advantage, over
  this rank's data group only (over the world every return would appear m
  times, and the quantiles' linear interpolation would read other values);
- ``mean_metrics``: the logged metrics, as global means;
- ``gather_weights``: the model axis's weights, every rank's block written
  into every rank's parameters (one flat all-gather over the model group);
- ``broadcast_rows``: a rollout round's new ring rows, from the model
  group's first rank (which steps the group's envs) to the group;
- ``broadcast`` and ``barrier``: rank 0's stop flag and eval reward, and the
  checkpoint's commit.

The layout: rank r of an ``[n, m]`` mesh has data index d = r // m and
model index j = r % m (``mesh.Mesh``).  Its *model group* is the m ranks of
data index d, which hold the same env block d and row block d of every
batch; its *data group* is the n ranks of model index j, which own the same
columns.  JAX's ``param_spec`` shards a 2-D kernel ``(in, out)`` over
``model`` on its output columns when ``out`` divides by m and is at least
256 (``model_blocks``); every other tensor is replicated.  The port keeps
every weight whole on every rank, because the hand kernels read whole
weights (the imagination is one launch with its weights resident, the GRU
kernels fuse the r, z, n gates that a column cut splits): a rank owns one
``Block`` of each sharded weight, keeps AdamW's moments of that block only,
computes the update of that block only, and ``gather_weights`` writes every
rank's block into the parameter.

Without a process group (one rank) every collective is the identity.  Each
collective waits for the device before and after it; its seconds add up in
``seconds`` and, by collective, in ``seconds_by`` (``calls`` counts them).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from dreamer_tpu_torch.parallel.mesh import Mesh

Tensor = torch.Tensor

# JAX's param_spec shards a kernel's output columns over `model` from this
# many columns on (dreamer_tpu/parallel/sharding.py:45-51).
MIN_SHARDED_COLUMNS = 256


def block(n: int, parts: int, index: int, what: str) -> slice:
    """Block ``index`` of ``n`` items cut into ``parts`` equal blocks."""
    if n % parts:
        raise ValueError(f"{what} {n} does not divide into {parts} data shards")
    per = n // parts
    return slice(index * per, (index + 1) * per)


@dataclass(frozen=True)
class Block:
    """Block ``index`` of ``parts`` equal blocks of a tensor along ``axis``:
    a rank's share of a weight sharded over the model axis."""

    axis: int
    index: int
    parts: int

    def of(self, t: Tensor, index: Optional[int] = None) -> Tensor:
        """The block (a view of ``t``); ``index`` names another rank's."""
        size = t.shape[self.axis] // self.parts
        return t.narrow(self.axis, (self.index if index is None else index) * size, size)


def column_axes(module: nn.Module) -> List[Optional[int]]:
    """For each parameter of ``module``, in ``parameters()`` order, the axis
    that holds its JAX kernel's output columns (2-D parameters; each module
    names its own in ``COLUMN_AXES``: a ``Dense.weight`` (out, in) its axis
    0, the GRU's flax-layout kernels (in, 3H) their axis 1), else None."""
    axes = {}
    for sub in module.modules():
        for name, axis in getattr(sub, "COLUMN_AXES", {}).items():
            axes[id(getattr(sub, name))] = axis
    out = []
    for name, p in module.named_parameters():
        if p.dim() == 2 and id(p) not in axes:
            raise ValueError(f"{name}: a 2-D parameter whose module names no column axis")
        out.append(axes.get(id(p)) if p.dim() == 2 else None)
    return out


def model_blocks(module: nn.Module, n_model: int, index: int
                 ) -> Optional[List[Optional[Block]]]:
    """JAX's ``param_spec`` on the port's layouts: for each parameter of
    ``module``, the ``Block`` that model index ``index`` of ``n_model`` owns
    where JAX shards it, else None; None for a model axis of 1."""
    if n_model == 1:
        return None
    out = []
    for p, axis in zip(module.parameters(), column_axes(module)):
        cols = None if axis is None else p.shape[axis]
        sharded = cols is not None and cols % n_model == 0 and cols >= MIN_SHARDED_COLUMNS
        out.append(Block(axis, index, n_model) if sharded else None)
    return out


class MeshPlan:
    def __init__(self, mesh: Mesh, device):
        self.mesh = mesh
        self.n_data = mesh.n_data
        self.n_model = mesh.n_model
        self.rank = mesh.rank
        self.world_size = mesh.world_size
        self.data_index = mesh.data_index
        self.model_index = mesh.model_index
        # The model group's first rank: it steps the group's envs, and its
        # checkpoint shard holds the group's ring.
        self.group_first = self.data_index * self.n_model
        self.device = torch.device(device)
        self.active = dist.is_initialized()
        # Host values (the stop flag, the eval reward, the ring rows) travel
        # on the CPU under gloo and on the card under nccl.
        self.host_device = (self.device if self.active and dist.get_backend() == "nccl"
                            else torch.device("cpu"))
        # The subgroups (None: the whole world).  Every rank creates every
        # group, in the same order, as new_group requires.
        self.model_group = self.data_group = None
        if self.active and self.n_model > 1:
            n, m = self.n_data, self.n_model
            for d in range(n):
                group = dist.new_group([d * m + j for j in range(m)])
                if d == self.data_index:
                    self.model_group = group
            for j in range(m):
                group = dist.new_group([d * m + j for d in range(n)])
                if j == self.model_index:
                    self.data_group = group
        self.seconds = 0.0
        self.calls = 0
        self.seconds_by: Dict[str, float] = {}

    @property
    def mesh_shape(self) -> Tuple[int, int]:
        return (self.n_data, self.n_model)

    # ------------------------------------------------------------------ #
    # Layout
    # ------------------------------------------------------------------ #

    def env_block(self, num_envs: int) -> slice:
        """This rank's envs of the global farm: its data index's block."""
        return block(num_envs, self.n_data, self.data_index, "the global env count")

    def row_block(self, batch_size: int) -> slice:
        """This rank's rows of a global batch: its data index's block."""
        return block(batch_size, self.n_data, self.data_index, "train.batch_size")

    def param_blocks(self, module: nn.Module) -> Optional[List[Optional[Block]]]:
        """This rank's block of each of ``module``'s parameters that the
        model axis shards (``model_blocks``)."""
        return model_blocks(module, self.n_model, self.model_index)

    # ------------------------------------------------------------------ #
    # Collectives
    # ------------------------------------------------------------------ #

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, name: str, collective, *args, **kwargs) -> None:
        self._sync()
        start = time.perf_counter()
        collective(*args, **kwargs)
        self._sync()
        seconds = time.perf_counter() - start
        self.seconds += seconds
        self.seconds_by[name] = self.seconds_by.get(name, 0.0) + seconds
        self.calls += 1

    def sum(self, x: Tensor) -> Tensor:
        """The sum of ``x`` over the ranks (a new tensor)."""
        out = x.detach().clone()
        if self.active:
            self._run("sum", dist.all_reduce, out, op=dist.ReduceOp.SUM)
        return out

    def reduce_update(self, grads: Sequence[Tensor], finite: Tensor
                      ) -> Tuple[List[Tensor], Tensor]:
        """The gradients averaged over the ranks and the update's finite flag
        true only where it is true on every rank: one flat all-reduce."""
        if not self.active:
            return list(grads), finite
        flat = torch.cat([g.reshape(-1).float() for g in grads]
                         + [(~finite).float().reshape(1)])
        self._run("reduce_update", dist.all_reduce, flat, op=dist.ReduceOp.SUM)
        out, i = [], 0
        for g in grads:
            out.append((flat[i:i + g.numel()] / self.world_size).view_as(g).to(g.dtype))
            i += g.numel()
        return out, flat[-1] == 0

    def gather(self, x: Tensor) -> Tensor:
        """Every data shard's ``x``, in data order along dim 0: an all-gather
        over this rank's data group."""
        group, size = self.data_group, self.n_data
        if not self.active:
            return x
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        self._run("gather", dist.all_gather, parts, x, group=group)
        return torch.cat(parts)

    def gather_weights(self, writes: Sequence[Tuple[Tensor, Block, Tensor]]) -> None:
        """Write an update of the model axis's weights: ``writes`` holds
        (parameter, this rank's block of it, the block's new value).  One
        flat all-gather over the model group brings every rank's blocks, and
        each is copied into the parameter itself (under ``no_grad``): a copy
        through the parameter moves its version counter, which the kernel
        layouts and the host actor's refresh read to see new weights."""
        if not writes:
            return
        mine = torch.cat([w.reshape(-1) for _, _, w in writes])
        if self.active:
            every = mine.new_empty(self.n_model * mine.numel())
            self._run("gather_weights", dist.all_gather_into_tensor, every, mine,
                      group=self.model_group)
            ranks = range(self.n_model)
        else:
            every, ranks = mine, [self.model_index]
        with torch.no_grad():
            for j, k in enumerate(ranks):
                i = j * mine.numel()
                for p, b, w in writes:
                    dst = b.of(p, k)
                    dst.copy_(every[i:i + w.numel()].view(dst.shape))
                    i += w.numel()

    def broadcast_rows(self, rows: Sequence[Optional[Tensor]]) -> None:
        """A round's new ring rows, from the model group's first rank to the
        group, in place: the first rank's tensors are sent, the others' (of
        the same shapes and dtypes, on ``host_device``) are overwritten."""
        if not self.active:
            return
        for t in rows:
            if t is not None:
                self._run("broadcast_rows", dist.broadcast, t, src=self.group_first,
                          group=self.model_group)

    def mean_metrics(self, metrics: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """Each metric's mean over the ranks: one flat all-reduce."""
        if not self.active:
            return metrics
        flat = torch.cat([v.detach().float().reshape(-1) for v in metrics.values()])
        self._run("mean_metrics", dist.all_reduce, flat, op=dist.ReduceOp.SUM)
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
        self._run("broadcast", dist.broadcast, t, src=0)
        return float(t.item())

    def barrier(self) -> None:
        if self.active:
            if self.host_device.type == "cuda":
                self._run("barrier", dist.barrier, device_ids=[self.host_device.index or 0])
            else:
                self._run("barrier", dist.barrier)
