"""Device operations (kernels, copies, sets) a step, from ``torch.profiler``."""


def read(trace: dict):
    ops = sum(c for c, _ in trace["device_ops"].values())
    return ops / trace["steps"] if ops and trace["steps"] else None
