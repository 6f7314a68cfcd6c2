from .engine import SlamEngine, EngineConfig, KeyframeStore  # noqa: F401
