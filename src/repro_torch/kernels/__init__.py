"""Hand-written CUDA kernels for the flat arena, their plain PyTorch
versions and the build that compiles them."""
