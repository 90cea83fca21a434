"""Hand-written CUDA kernels (sources in ``qrag_tpu_torch/csrc``)."""
