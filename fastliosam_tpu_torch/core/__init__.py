from . import so3, se3, eigh3, pointcloud  # noqa: F401
