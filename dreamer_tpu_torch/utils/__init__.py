from dreamer_tpu_torch.utils.checkpoint import CheckpointManager
from dreamer_tpu_torch.utils.metrics import MetricsLogger

__all__ = ["CheckpointManager", "MetricsLogger"]
