from dreamer_tpu_torch.replay.buffer import ReplayBuffer, ReplayState

__all__ = ["ReplayBuffer", "ReplayState"]
