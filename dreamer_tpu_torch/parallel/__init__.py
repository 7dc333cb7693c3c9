from dreamer_tpu_torch.parallel.distributed import (hosts, init_distributed, is_primary, rank,
                                                   rank_device, shutdown, world_size)
from dreamer_tpu_torch.parallel.mesh import make_mesh, refuse_model_axis
from dreamer_tpu_torch.parallel.sharding import MeshPlan

__all__ = ["MeshPlan", "hosts", "init_distributed", "is_primary", "make_mesh", "rank",
           "rank_device", "refuse_model_axis", "shutdown", "world_size"]
