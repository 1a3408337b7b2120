"""Hot-path ops and their CUDA kernels."""
