from .world import PlaneWorld, Trajectory, SimConfig, simulate_sequence  # noqa: F401
