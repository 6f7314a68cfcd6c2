from .state import NavState, init_state, boxplus, OdomConfig  # noqa: F401
from .imu import ImuBatch, propagate, deskew  # noqa: F401
from .iekf import iekf_update  # noqa: F401
from .pipeline import Scan, OdomState, init_odom, odom_step, odom_rollout  # noqa: F401
