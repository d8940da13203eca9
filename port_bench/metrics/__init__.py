"""Per-layer metric readers, one file each, named as the metric: each
``read(record)`` (``harness.Record``) returns the metric's value, or
None where the cell gives it nothing to read."""
