"""Utilities of the port (``repro.utils``): ``hlo_analysis``, the per-device
work counter of the dry-run."""
