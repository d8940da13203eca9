"""Scoring of synthesized volumes."""
from .metrics_driver import (IdUniquifier, aggregate_metrics,
                             compute_volume_metrics)

__all__ = ["IdUniquifier", "aggregate_metrics", "compute_volume_metrics"]
