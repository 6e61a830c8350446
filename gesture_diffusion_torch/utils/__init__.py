from .device import resolve_device
from .json_config import JsonConfig

__all__ = ["JsonConfig", "resolve_device"]
