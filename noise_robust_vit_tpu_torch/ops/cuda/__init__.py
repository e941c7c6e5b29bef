"""Hand-written CUDA kernels for Hopper (``sm_90a``), their ctypes wrappers
and their plain PyTorch versions (counterpart of
``noise_robust_vit_tpu/ops/pallas``). Sources are under ``csrc/``; ``build``
compiles them at first use."""
