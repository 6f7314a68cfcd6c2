"""Post-processing: so far the standalone HTML map viewer that
``runtime/persistence.py: save_results`` writes."""
from .viewer3d import write_map_viewer  # noqa: F401
