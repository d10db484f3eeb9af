"""Examples (``examples/`` of the reference), runnable as modules:
``python -m repro_torch.examples.quickstart [--device cpu]``."""
