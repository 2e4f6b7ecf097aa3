"""Hand-written GPU kernels: each module holds one kernel's wrapper, its
plain PyTorch version and its launch count; ``build.py`` compiles the
CUDA sources in ``csrc/``."""
