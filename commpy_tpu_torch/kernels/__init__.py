"""Hand-written CUDA kernels (sources in ``csrc/``, built at first use)."""
