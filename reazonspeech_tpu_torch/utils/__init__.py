from .compile_cache import ENV_VAR, enable_compile_cache
from .profiling import RTFxMeter, count, counters, reset, span, spans, trace

__all__ = ["ENV_VAR", "RTFxMeter", "count", "counters", "enable_compile_cache", "reset", "span",
           "spans", "trace"]
