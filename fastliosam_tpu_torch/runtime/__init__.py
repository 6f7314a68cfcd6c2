from .engine import EngineConfig, GpsFix, KeyframeStore, SlamEngine  # noqa: F401
