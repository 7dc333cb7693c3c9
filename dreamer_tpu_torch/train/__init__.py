from dreamer_tpu_torch.train.agent import ACNoise, AgentTrainer
from dreamer_tpu_torch.train.state import ACTrainState, AdamState
from dreamer_tpu_torch.train.step import Policy, PolicyNoise, Trainer, resolve_device

__all__ = ["ACNoise", "ACTrainState", "AdamState", "AgentTrainer", "Policy", "PolicyNoise",
           "Trainer", "resolve_device"]
