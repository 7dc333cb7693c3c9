from dreamer_tpu_torch.train.step import Policy, PolicyNoise, resolve_device

__all__ = ["Policy", "PolicyNoise", "resolve_device"]
