"""Architecture registry of the port: `base.get_config(name)`."""
from .base import ModelConfig, get_config, get_smoke_config  # noqa: F401
