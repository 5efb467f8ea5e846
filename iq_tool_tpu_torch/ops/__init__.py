"""Signal-processing operators and the hand-written CUDA kernels."""
