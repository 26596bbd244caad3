"""The assigned input-shape cells and their stand-in tensors.

Counterpart of ``repro.launch.shapes``.  Four shapes per LM architecture
(40 cells):

  train_4k     seq 4096,   global_batch 256   -> train step
  prefill_32k  seq 32768,  global_batch 32    -> prefill
  decode_32k   seq 32768,  global_batch 128   -> decode (1 new token)
  long_500k    seq 524288, global_batch 1     -> decode; only for
               sub-quadratic archs (cfg.supports_long_context), the others
               recorded as skipped.

The spec functions return tensors on ``device``: ``meta`` by default, so
nothing is allocated at full size; the dry run passes ``cpu`` under
``FakeTensorMode``, which makes fake tensors.  Dtypes are the port's: ids
int64 (``Trainer.batch_at``), frontend embeddings f32.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class ShapeCell:
  name: str
  seq_len: int
  global_batch: int
  kind: str                  # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg, shape: ShapeCell) -> tuple[bool, str]:
  if shape.name == "long_500k" and not cfg.supports_long_context:
    return False, ("pure full-attention arch: 500k-token decode needs "
                   "sub-quadratic attention (skip per assignment)")
  return True, ""


def _empty(shape, dtype, device) -> torch.Tensor:
  return torch.empty(shape, dtype=dtype, device=device)


def batch_specs(cfg, shape: ShapeCell, device="meta") -> dict:
  """The train or prefill batch dict."""
  b, s = shape.global_batch, shape.seq_len
  ids = torch.int64
  if cfg.frontend == "audio":
    specs = {"embeds": _empty((b, s, cfg.d_model), torch.float32, device)}
    if shape.kind == "train":
      specs["targets"] = _empty((b, s, cfg.num_codebooks), ids, device)
    return specs
  if cfg.frontend == "vision":
    st = s - cfg.num_patches
    specs = {"tokens": _empty((b, st), ids, device),
             "image_embeds": _empty((b, cfg.num_patches, cfg.d_model),
                                    torch.float32, device)}
    if shape.kind == "train":
      specs["targets"] = _empty((b, st), ids, device)
    return specs
  specs = {"tokens": _empty((b, s), ids, device)}
  if shape.kind == "train":
    specs["targets"] = _empty((b, s), ids, device)
  return specs


def decode_token_specs(cfg, shape: ShapeCell, device="meta") -> torch.Tensor:
  b = shape.global_batch
  if cfg.frontend == "audio":
    return _empty((b, cfg.d_model), torch.float32, device)
  return _empty((b,), torch.int64, device)


def cache_specs(cfg, shape: ShapeCell, device="meta") -> list[dict]:
  """The decode caches at ``seq_len`` positions, one dict per layer."""
  return T.init_cache(cfg, shape.global_batch, shape.seq_len, device)
