from dreamer_tpu_torch.core.dists import (actor_mu_sigma, sample_gumbel,
                                          sample_onehot_ste, unimix_probs)

__all__ = ["actor_mu_sigma", "sample_gumbel", "sample_onehot_ste", "unimix_probs"]
