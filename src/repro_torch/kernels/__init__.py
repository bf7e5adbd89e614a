"""Hand-written GPU kernels: wrappers and plain versions in this package, CUDA
sources under ``csrc/``, built at first use by ``build.py``."""
