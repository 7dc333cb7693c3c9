from dreamer_tpu_torch.train.agent import ACNoise, AgentTrainer
from dreamer_tpu_torch.train.state import ACTrainState, AdamState, DreamerState, WMTrainState
from dreamer_tpu_torch.train.step import Policy, PolicyNoise, Trainer, resolve_device
from dreamer_tpu_torch.train.world_model import (make_wm_optimizer, wm_loss, wm_loss_terms,
                                                 wm_update)

__all__ = ["ACNoise", "ACTrainState", "AdamState", "AgentTrainer", "DreamerState", "Policy",
           "PolicyNoise", "Trainer", "WMTrainState", "make_wm_optimizer", "resolve_device",
           "wm_loss", "wm_loss_terms", "wm_update"]
