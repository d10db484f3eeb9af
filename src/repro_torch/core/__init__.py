"""Detector core, mirroring ``repro.core`` module by module.

Submodules (import them directly; this package imports nothing eagerly):
  tos, stcf, ber, harris — the per-chunk operators (plain PyTorch)
  prng     — JAX-compatible threefry2x32 (BER draws are draw-exact)
  dvfs     — operating-point table and the streaming rate estimator
  hwmodel, pr_eval — copies of the host-side energy model and PR-AUC
  baselines — eHarris / evFAST / evARC, the detectors the paper compares
  state    — lane-batched ``DetectorState`` and ``detector_step``
  pipeline — ``run_pipeline`` / ``run_pipeline_batched``
"""
