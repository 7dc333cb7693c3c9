from dreamer_tpu_torch.rssm.rssm import RSSM, ImaginedTrajectory, ObservedSequence

__all__ = ["RSSM", "ImaginedTrajectory", "ObservedSequence"]
