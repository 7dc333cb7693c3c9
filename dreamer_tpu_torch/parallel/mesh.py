"""The (data, model) layout of ``runtime.mesh_shape`` over the ranks of the
process group (the port of ``dreamer_tpu/parallel/mesh.py``).

The ``data`` axis is data parallelism: the ranks of one data index step the
same block of envs, keep their replay streams and take the same block of
every batch's rows; the gradients are averaged over the ranks.  The
``model`` axis (JAX's tensor parallelism over the big 2-D kernels' output
columns, ``dreamer_tpu/parallel/sharding.py:45-58``) splits the optimizer
state of those weights: each rank of a model group owns one block of their
columns, and updates and keeps the moments of that block only
(``parallel.sharding``).

Rank r of an ``[n, m]`` mesh has data index ``r // m`` and model index
``r % m``: the model axis varies fastest, as ``mesh_utils.create_device_mesh``
lays out JAX's grid, so a model group is m neighbouring ranks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from dreamer_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Mesh:
    n_data: int
    n_model: int
    rank: int
    world_size: int

    @property
    def data_index(self) -> int:
        """This rank's place on the data axis: its block of envs and rows."""
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        """This rank's place in its model group: its block of the sharded
        weights' columns."""
        return self.rank % self.n_model


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The mesh of this process group: ``n_data x n_model`` must be the
    world size (``n_data`` defaults to the world over ``n_model``)."""
    world = distributed.world_size()
    if n_model < 1 or (n_data is not None and n_data < 1):
        raise ValueError(f"runtime.mesh_shape [{n_data}, {n_model}]: both axes must be >= 1")
    n_data = world // n_model if n_data is None else n_data
    if n_data * n_model != world:
        raise ValueError(f"runtime.mesh_shape [{n_data}, {n_model}] needs {n_data * n_model} "
                         f"ranks, the world has {world}")
    return Mesh(n_data, n_model, distributed.rank(), world)
