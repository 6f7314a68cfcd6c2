"""Device-to-host synchronisations a step, counted over the traced steps by
``torch.cuda.set_sync_debug_mode`` (one warning a synchronising call)."""


def read(trace: dict):
    return trace["syncs"] / trace["steps"] if trace["steps"] else None
