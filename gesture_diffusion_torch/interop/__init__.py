from .jax_import import (glide_unet_state_dict_from_jax,
                         jax_checkpoint_state_dict, jax_params_state_dict,
                         motion_ae_state_dict_from_jax,
                         primer_state_dict_from_jax,
                         se_bottleneck_state_dict_from_jax, state_dict_from_jax)

__all__ = ["glide_unet_state_dict_from_jax", "jax_checkpoint_state_dict",
           "jax_params_state_dict", "motion_ae_state_dict_from_jax",
           "primer_state_dict_from_jax", "se_bottleneck_state_dict_from_jax",
           "state_dict_from_jax"]
