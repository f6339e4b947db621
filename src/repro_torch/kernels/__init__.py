"""CUDA kernels of the port, one sub-package per TPU kernel of
``repro.kernels`` that it replaces. Sources are under ``csrc/``; see
``_build.py``."""
