from .gaussian import (Schedule, make_schedule, mean_flat, p_mean_variance,
                       predict_eps_from_xstart, predict_xstart_from_eps,
                       q_mean_variance, q_posterior_mean_variance, q_sample,
                       training_losses)
from .losses import continuous_gaussian_log_likelihood, normal_kl
from .respace import make_diffusion, respaced_schedule, space_timesteps
from .sampling import (bpd_loop, ddim_sample_loop, ddpm_sample_loop,
                       prior_bpd, wrap_respaced)
from .schedules import get_named_beta_schedule

__all__ = [
    "Schedule", "make_schedule", "predict_xstart_from_eps",
    "predict_eps_from_xstart", "q_mean_variance", "q_sample",
    "q_posterior_mean_variance", "p_mean_variance", "mean_flat",
    "training_losses",
    "normal_kl", "continuous_gaussian_log_likelihood", "make_diffusion",
    "respaced_schedule", "space_timesteps", "ddim_sample_loop",
    "ddpm_sample_loop", "prior_bpd", "bpd_loop", "wrap_respaced",
    "get_named_beta_schedule",
]
