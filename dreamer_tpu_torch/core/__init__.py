from dreamer_tpu_torch.core.dists import (actor_mu_sigma, categorical_kl, normal_entropy,
                                          sample_gumbel, sample_onehot_ste,
                                          tanh_normal_logprob, unimix_probs)

__all__ = ["actor_mu_sigma", "categorical_kl", "normal_entropy", "sample_gumbel",
           "sample_onehot_ste", "tanh_normal_logprob", "unimix_probs"]
