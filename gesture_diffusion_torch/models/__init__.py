from .denoiser import (DenoiserConfig, GestureDenoiser, timestep_embedding,
                       timestep_freqs)
from .factory import ModelBundle, build_all, build_model, init_random_

__all__ = ["DenoiserConfig", "GestureDenoiser", "timestep_embedding",
           "timestep_freqs", "ModelBundle", "build_all", "build_model",
           "init_random_"]
