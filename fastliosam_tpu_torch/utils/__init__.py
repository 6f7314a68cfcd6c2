from .timing import StageTimer, colorize  # noqa: F401
from .device import resolve_device, to_device, upload  # noqa: F401
from .precision import geometry_precision  # noqa: F401
from .sync import host_read, host_reads, reset_host_reads  # noqa: F401
