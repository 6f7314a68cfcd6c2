from .engine import EngineConfig, GpsFix, KeyframeStore, SlamEngine  # noqa: F401
from .persistence import (  # noqa: F401
    save_results,
    save_checkpoint,
    load_checkpoint,
)
from .localizer import MapLocalizer, build_map_from_keyframes  # noqa: F401
