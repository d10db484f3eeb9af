"""Hand-written CUDA kernels for the detector's hot path, each beside its
plain PyTorch version.

* ``fused_step``  — K1: one chunk's STCF keep/score, SAE scatter-max, TOS
  patch update and BER write errors (``csrc/fused_step.cu``).
* ``harris_conv`` — K2: the Harris response map that refreshes the corner
  LUT (``csrc/harris.cu``).
* ``ops``         — the dispatching wrappers: a CPU tensor gets the plain
  version, a CUDA tensor gets the kernel (or an error).  Each counts its
  kernel launches.
* ``_build``      — ``nvcc`` build into ``build/kernels/`` and the ctypes
  loader.
"""
