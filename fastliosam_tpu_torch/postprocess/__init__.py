"""Post-processing: so far the standalone HTML map viewer that
``runtime/persistence.py: save_results`` writes, and the image decode and
undistortion the sensor recorder calls (``images.py``)."""
from .viewer3d import write_map_viewer  # noqa: F401
