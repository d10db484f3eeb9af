"""Hand-written CUDA kernels for the detector's hot path, each beside its
plain PyTorch version.

* ``fused_step``  — K1: one chunk's STCF keep/score, SAE scatter-max, TOS
  patch update and BER write errors (``csrc/fused_step.cu``).
* ``harris_conv`` — K2: the Harris response map that refreshes the corner
  LUT (``csrc/harris.cu``).
* ``compact``     — K3: stream compaction of result rows into kept-event
  records for the pool's compact readout (``csrc/compact.cu``).
* ``tos_update``  — K4-K7: the chunked TOS update on its own (NMC replay,
  closed form, and both binned per 128x128 tile) for the ``"nmc"`` /
  ``"batched"`` backends: ``csrc/tos_update.cu`` computes the replay's
  closed form per 64x64 tile (K4, K6), ``csrc/tos_count.cu`` counts on
  the tensor cores (K5, K7).
* ``ber_draw``    — the write-error draw: every lane's key split and its
  per-pixel 5-bit xor masks in one launch, bit-exact to the plain threefry
  (``csrc/ber_draw.cu``; it replaces no TPU kernel).
* ``ops``         — the dispatching wrappers: a CPU tensor gets the plain
  version, a CUDA tensor gets the kernel (or an error).  Each counts its
  kernel launches.
* ``_build``      — ``nvcc`` build into ``build/kernels/`` and the ctypes
  loader.
"""
