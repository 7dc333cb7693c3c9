from dreamer_tpu_torch.rssm.rssm import RSSM, ImaginedTrajectory

__all__ = ["RSSM", "ImaginedTrajectory"]
