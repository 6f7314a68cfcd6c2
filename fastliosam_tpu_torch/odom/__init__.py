from .state import NavState, init_state, boxplus, OdomConfig  # noqa: F401
from .imu import ImuBatch, propagate, deskew  # noqa: F401
from .iekf import iekf_update  # noqa: F401
from .pipeline import (  # noqa: F401
    Scan, OdomState, gravity_from_imu, init_odom, odom_step, odom_rollout,
    odom_step_batched, odom_rollout_batched,
)
