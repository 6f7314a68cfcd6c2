from .metrics import ate_rmse, rpe, align_umeyama  # noqa: F401
