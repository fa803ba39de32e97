"""Accuracy evaluation for the port: harness, synthetic data and training,
the CLI (``python -m gear_tpu_torch.eval.run``)."""
from . import harness  # noqa: F401
