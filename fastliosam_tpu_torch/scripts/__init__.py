"""Entry points run with ``python -m fastliosam_tpu_torch.scripts.<name>``."""
