from .defaults import cfg, get_default_cfg
from .node import ConfigNode

__all__ = ["cfg", "get_default_cfg", "ConfigNode"]
