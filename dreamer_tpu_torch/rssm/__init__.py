from dreamer_tpu_torch.rssm.rssm import RSSM

__all__ = ["RSSM"]
