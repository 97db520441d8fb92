"""PyTorch/CUDA port of the DMO arena system.

The planning core (:mod:`repro_torch.core`) is the reference package's pure
Python and numpy, copied; the executor runs the planned flat arena on an
NVIDIA Hopper card through hand-written sm_90a kernels
(:mod:`repro_torch.kernels`). This package imports torch and numpy only.
"""
