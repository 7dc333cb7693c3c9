from dreamer_tpu_torch.orchestrator.dreamer import Dreamer

__all__ = ["Dreamer"]
