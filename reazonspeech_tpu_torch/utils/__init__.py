from .compile_cache import ENV_VAR, enable_compile_cache
from .profiling import RTFxMeter, trace

__all__ = ["ENV_VAR", "RTFxMeter", "enable_compile_cache", "trace"]
