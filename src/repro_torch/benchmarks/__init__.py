"""The port's benchmarks (``benchmarks/`` of the reference), each with the
reference's row names and sizes: ``bench_streaming`` (the serving rows),
``scenarios`` (the five fleet SLO scenarios) and ``run`` (the runner,
``python -m repro_torch.benchmarks.run [--smoke] [--device cpu]``)."""
