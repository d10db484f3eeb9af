"""The port's benchmarks (``benchmarks/`` of the reference), each with the
reference's row names and sizes: ``bench_hwmodel``, ``bench_throughput``,
``bench_dvfs`` and ``bench_auc`` (the paper's figures), ``bench_tos_kernels``
(the TOS kernels' cost model on the H100), ``bench_streaming`` (the serving
rows), ``scenarios`` (the five fleet SLO scenarios) and ``run`` (the runner
and its regression gate, ``python -m repro_torch.benchmarks.run [--smoke]
[--device cpu] [--check-regression BASELINE]``); ``bounds`` (the H100's
rates and the kernels' bounds) and ``timing`` (device timers) serve them and
``chip_smoke.py``."""
