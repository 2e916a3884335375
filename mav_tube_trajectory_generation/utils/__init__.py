from . import timing, export, checkpointing, compile_cache
