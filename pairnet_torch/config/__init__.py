from .core import Config, apply_overrides, load_config, parse_override
from .registry import DATASETS, Registry

__all__ = [
    "Config",
    "apply_overrides",
    "load_config",
    "parse_override",
    "Registry",
    "DATASETS",
]
