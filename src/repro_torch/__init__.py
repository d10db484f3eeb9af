"""PyTorch/CUDA port of the NMC-TOS event-camera corner detector.

A second package beside the JAX reference ``repro``, laid out with the same
module names so each port module names its counterpart:

  ``events``  — numpy synthetic streams and chunk stacking.
  ``core``    — the detector: STCF, TOS, BER, Harris, DVFS, the JAX-exact
                threefry PRNG, the lane-batched ``DetectorState`` step and
                the batch pipeline (``core.pipeline.run_pipeline``).
  ``kernels`` — hand-written CUDA kernels for the H100 (``csrc/*.cu``,
                built with ``nvcc`` for ``sm_90a`` at first use) beside the
                plain PyTorch version of each; ``kernels.ops`` dispatches on
                the tensor's device.

The package imports ``torch`` and numpy only — never ``jax`` and nothing of
``repro``.  Entry points run on ``cuda`` unless the caller asks for ``cpu``.
"""
