from .jax_import import motion_ae_state_dict_from_jax, state_dict_from_jax

__all__ = ["motion_ae_state_dict_from_jax", "state_dict_from_jax"]
