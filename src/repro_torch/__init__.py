"""PyTorch/CUDA port of the ``repro`` soft sorting and ranking system.

Imports ``torch`` and never ``jax`` or ``repro``.  The operators follow
their input's device: on a CUDA tensor the isotonic solve runs the
hand-written kernels in ``repro_torch/kernels/csrc`` (built with nvcc at
first use), on a CPU tensor their plain PyTorch version.
"""

from repro_torch import core
from repro_torch.core import *  # noqa: F401,F403

__all__ = list(core.__all__)
