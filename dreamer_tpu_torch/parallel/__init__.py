from dreamer_tpu_torch.parallel.distributed import (hosts, init_distributed, is_primary, rank,
                                                   rank_device, shutdown, world_size)
from dreamer_tpu_torch.parallel.mesh import make_mesh
from dreamer_tpu_torch.parallel.sharding import MeshPlan, model_blocks

__all__ = ["MeshPlan", "hosts", "init_distributed", "is_primary", "make_mesh", "model_blocks",
           "rank", "rank_device", "shutdown", "world_size"]
