"""The (data, model) layout of ``runtime.mesh_shape`` over the ranks of the
process group (the port of ``dreamer_tpu/parallel/mesh.py``).

The ``data`` axis is data parallelism: each rank holds the whole model,
steps its own block of envs, keeps their replay streams and takes its block
of every batch's rows; the gradients are averaged over the ranks.  The
``model`` axis (tensor parallelism over the big 2-D kernels'
output columns, ``dreamer_tpu/parallel/sharding.py:48-54``) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from dreamer_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"


def refuse_model_axis(n_model: int) -> None:
    if n_model != 1:
        raise ValueError(
            f"runtime.mesh_shape's model axis of {n_model} (tensor parallelism over the big "
            "kernels' output columns) is not ported yet: ROADMAP Queue 1 item 8, the model "
            "axis; the data axis runs ([n, 1])")


@dataclass(frozen=True)
class Mesh:
    n_data: int
    n_model: int
    rank: int
    world_size: int


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The mesh of this process group: ``n_data x n_model`` must be the
    world size (``n_data`` defaults to it)."""
    refuse_model_axis(n_model)
    world = distributed.world_size()
    n_data = world if n_data is None else n_data
    if n_data * n_model != world:
        raise ValueError(f"runtime.mesh_shape [{n_data}, {n_model}] needs {n_data * n_model} "
                         f"ranks, the world has {world}")
    return Mesh(n_data, n_model, distributed.rank(), world)
