"""Hand-written CUDA kernels (sources in `hyperspace_tpu_torch/csrc/`),
built with `nvcc` at first use (`build.py`) and bound with ctypes."""
