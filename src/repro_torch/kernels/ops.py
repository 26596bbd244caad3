"""Public wrappers for the CUDA kernels and their plain versions.

``repro_torch.kernels.dispatch`` routes batched isotonic forward passes here:
``pav_l2`` / ``pav_kl`` (the ``"cuda"`` backend) for CUDA tensors, and
``pav_l2_stack`` / ``pav_kl_stack`` (the ``"stack"`` backend, the same stack
machine in plain PyTorch) for tensors on the CPU.  The backward is
backend-independent segment algebra (``repro_torch.kernels.segment_vjp``).

The models call the router gate ``soft_topk_gates``, the attention
``flash_attention`` and, in a decode step, ``decode_attention.decode_block``:
each runs its kernel on a CUDA tensor and its plain version
(``soft_topk_gates_plain``, ``flash_attention_plain``,
``decode_block_plain``) on a CPU tensor.  Every kernel module keeps its own ``LAUNCHES`` count;
``reset_all_launches`` zeroes them all and ``all_launches`` reads them.
"""

from __future__ import annotations

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import pav as _pav
from repro_torch.kernels import soft_topk as _st
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_plain,
)
from repro_torch.kernels.pav import (
    LAUNCHES,
    pav_kl,
    pav_kl_stack,
    pav_l2,
    pav_l2_stack,
    reset_launches,
)
from repro_torch.kernels.soft_topk import soft_topk_gates, soft_topk_gates_plain

__all__ = ["pav_l2", "pav_kl", "pav_l2_stack", "pav_kl_stack", "LAUNCHES",
           "reset_launches", "soft_topk_gates", "soft_topk_gates_plain",
           "flash_attention", "flash_attention_plain", "reset_all_launches",
           "all_launches"]

_KERNEL_MODULES = (_pav, _st, _fa, _da)


def reset_all_launches() -> None:
  """Set the launch count of every kernel to 0."""
  for mod in _KERNEL_MODULES:
    mod.reset_launches()


def all_launches() -> dict[str, int]:
  """Launch counts of every kernel, by kernel name."""
  out: dict[str, int] = {}
  for mod in _KERNEL_MODULES:
    out.update(mod.LAUNCHES)
  return out
