"""The popcount-semiring GEMM: plain version, CUDA kernel, dispatch."""
