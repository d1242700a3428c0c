"""Model zoo: layers + family assemblies (see transformer.py)."""
from . import layers, transformer
from .transformer import decode_step, forward, init, init_cache

__all__ = ["layers", "transformer",
           "init", "forward", "init_cache", "decode_step"]
