"""Evaluation metrics (port of ``psla_tpu/metrics``)."""

from psla_tpu_torch.metrics.stats import (  # noqa: F401
    calculate_stats,
    d_prime,
    mean_average_precision,
)
