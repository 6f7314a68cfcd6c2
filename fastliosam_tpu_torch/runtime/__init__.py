from .engine import EngineConfig, GpsFix, KeyframeStore, SlamEngine  # noqa: F401
from .persistence import (  # noqa: F401
    save_results,
    save_checkpoint,
    load_checkpoint,
)
from .localizer import MapLocalizer, build_map_from_keyframes  # noqa: F401
from .recorder import SensorRecorder, RecorderConfig  # noqa: F401
from .telemetry import (  # noqa: F401
    HttpSink,
    WebSocketSink,
    make_envelope,
    multi_sink,
)
