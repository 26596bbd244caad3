"""Kernels of the port: hand-written CUDA for Hopper, with plain versions.

``csrc/*.cu`` are built with nvcc at first use (``_build``) and loaded with
ctypes; nothing here imports or builds anything at import time.
"""
