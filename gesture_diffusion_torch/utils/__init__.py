from .device import resolve_device
from .json_config import JsonConfig
from .parsing import parse_steps
from .rng import RngStream

__all__ = ["JsonConfig", "RngStream", "parse_steps", "resolve_device"]
