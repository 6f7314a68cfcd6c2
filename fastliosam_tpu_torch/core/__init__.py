from . import so3, se3, eigh3, pointcloud, geodesy  # noqa: F401
