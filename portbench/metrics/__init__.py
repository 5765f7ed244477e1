"""Metric readers, one file each, named as the metric: ``read(run)``
returns the metric's value, or None where the run has nothing to read."""
