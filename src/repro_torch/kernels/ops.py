"""Public wrappers for the CUDA kernels and their plain versions.

``repro_torch.kernels.dispatch`` routes batched isotonic forward passes here:
``pav_l2`` / ``pav_kl`` (the ``"cuda"`` backend) for CUDA tensors, and
``pav_l2_stack`` / ``pav_kl_stack`` (the ``"stack"`` backend, the same stack
machine in plain PyTorch) for tensors on the CPU.  The backward is
backend-independent segment algebra (``repro_torch.kernels.segment_vjp``).
"""

from __future__ import annotations

from repro_torch.kernels.pav import (
    LAUNCHES,
    pav_kl,
    pav_kl_stack,
    pav_l2,
    pav_l2_stack,
    reset_launches,
)

__all__ = ["pav_l2", "pav_kl", "pav_l2_stack", "pav_kl_stack", "LAUNCHES",
           "reset_launches"]
