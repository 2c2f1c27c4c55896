from .cache import enable_compile_cache
from .checkpoint import load_carry, save_carry
from .profiling import StageTimer, annotate, trace

__all__ = ["enable_compile_cache", "save_carry", "load_carry", "StageTimer",
           "annotate", "trace"]
