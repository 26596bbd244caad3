"""Roofline terms of a dry-run cell, with one NVIDIA H100's constants.

Counterpart of ``repro.analysis.roofline``, whose constants are a TPU
v5e's; these are the card's (NVIDIA H100 80GB HBM3, SXM, 700 W):

  compute_s    = FLOPs_per_device / 989e12   (dense bf16 tensor-core peak,
                                              NVIDIA H100 data sheet)
  memory_s     = HBM_bytes_per_device / 3.35e12   (HBM3, data sheet)
  collective_s = collective_bytes_per_device / 50e9   (the reference's
                 per-link model, at one 400 Gb/s NDR InfiniBand port per
                 GPU: on nodes of 8 H100s, the 16-way model axis crosses
                 nodes)

MODEL_FLOPS = 6 N D (train) or 2 N D (inference), N the active matmul
parameters; MODEL_FLOPS / (traced FLOPs x devices) exposes remat,
dispatch and masking work.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12          # bf16 FLOP/s, dense (H100 SXM data sheet)
HBM_BW = 3.35e12             # bytes/s (H100 SXM HBM3, data sheet)
LINK_BW = 50e9               # bytes/s per link: 400 Gb/s NDR InfiniBand


def count_active_params(cfg, model) -> tuple[int, int]:
  """(total, active-matmul) parameter counts over ``model``'s parameters
  (on any device, ``meta`` included), by the reference's rule on its own
  layouts: a leaf counts as a matmul when it has two dims or more, where a
  layer's leaves carry the reference's stacking dim (so every layer leaf
  counts, its norm scales too); the embedding table only when tied; the
  routed experts at ``experts_per_token`` of ``num_experts``."""
  total = active = 0
  for name, p in model.named_parameters():
    path = name.replace(".", "/")
    n = p.numel()
    total += n
    if "embed/table" in path and not cfg.tie_embeddings:
      continue  # pure lookup, no matmul
    if p.dim() + name.startswith("layers.") < 2:
      continue
    if "/we_" in path:
      n = n * cfg.experts_per_token // max(cfg.num_experts, 1)
    active += n
  return total, active


def model_flops(cfg, model, shape_cell) -> float:
  _, active = count_active_params(cfg, model)
  if shape_cell.kind == "train":
    return 6.0 * active * shape_cell.global_batch * shape_cell.seq_len
  if shape_cell.kind == "prefill":
    return 2.0 * active * shape_cell.global_batch * shape_cell.seq_len
  return 2.0 * active * shape_cell.global_batch  # decode: one token a row


def roofline_terms(parsed: dict, num_devices: int,
                   model_flops_total: float) -> dict:
  compute_s = parsed["flops_per_device"] / PEAK_FLOPS
  memory_s = parsed["hbm_bytes_per_device"] / HBM_BW
  coll_s = parsed["collective_bytes_per_device"] / LINK_BW
  terms = {"compute_s": compute_s, "memory_s": memory_s,
           "collective_s": coll_s}
  dominant = max(terms, key=terms.get)
  traced_total = parsed["flops_per_device"] * num_devices
  return {
      **terms,
      "dominant": dominant,
      "bound_s": terms[dominant],
      "model_flops": model_flops_total,
      "hlo_flops_total": traced_total,
      "useful_flops_ratio": (model_flops_total / traced_total
                             if traced_total else 0.0),
      # the share of the compute roofline reached if the dominant term
      # sets the step time
      "roofline_fraction": (model_flops_total /
                            (num_devices * PEAK_FLOPS * terms[dominant])
                            if terms[dominant] > 0 else 0.0),
  }
