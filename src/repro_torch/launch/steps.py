"""Prefill and decode step builders.

Counterpart of ``repro.launch.steps.make_prefill_step`` /
``make_decode_step``: the functions the server drives.  PyTorch runs them
eagerly; there is nothing to jit.
"""

from __future__ import annotations

from repro_torch.models import transformer as T


def make_prefill_step(cfg, max_len: int | None = None):
  """(model, batch) -> (last-position logits (B, V), caches)."""
  def prefill(model, batch):
    return T.forward_prefill(cfg, model, batch,
                             max_len or batch["tokens"].shape[1])
  return prefill


def make_decode_step(cfg):
  """(model, caches, tokens (B,), pos) -> (logits (B, V), caches)."""
  def decode(model, caches, inputs, pos):
    return T.forward_decode(cfg, model, caches, inputs, pos)
  return decode
