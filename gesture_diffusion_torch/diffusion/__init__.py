from .gaussian import (Schedule, make_schedule, predict_eps_from_xstart,
                       predict_xstart_from_eps)
from .respace import make_diffusion, respaced_schedule, space_timesteps
from .sampling import ddim_sample_loop, wrap_respaced
from .schedules import get_named_beta_schedule

__all__ = [
    "Schedule", "make_schedule", "predict_xstart_from_eps",
    "predict_eps_from_xstart", "make_diffusion", "respaced_schedule",
    "space_timesteps", "ddim_sample_loop", "wrap_respaced",
    "get_named_beta_schedule",
]
