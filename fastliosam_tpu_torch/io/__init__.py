from .pcd import read_pcd, write_pcd  # noqa: F401
from .poses import (  # noqa: F401
    read_kitti_poses,
    read_tum_trajectory,
    write_kitti_poses,
    write_tum_trajectory,
    unix_to_readable,
)
from .kitti import KittiSequence  # noqa: F401
from .generic import GenericSequence  # noqa: F401
