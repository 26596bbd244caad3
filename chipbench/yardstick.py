"""The yardstick's arithmetic: the card's peaks, model FLOPs from a
configuration's dimensions, the attention kernel's least time, the bytes
a decode step must move.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the 700 W power limit
(the same numbers as ``src/repro_torch/analysis/roofline.py``): 989e12
bf16 FLOP/s on the tensor cores, 67e12 f32 FLOP/s outside them, 3.35e12
HBM3 bytes/s.  A card set below 700 W (``nvidia-smi``'s power.limit, which
each run prints beside its numbers) runs below these.

Model FLOPs count the products a token needs, from the configuration file
(``model``): 2 FLOPs a multiply-add of every weight the token meets (its
k routed experts, not the capacity slots the dispatch computes; no
embedding lookup), and the attention products over the causal pairs.
Training counts 3 times the forward (forward, and the backward's two
products), with no recompute; the norm scales and the router's softmax
are left out (under 0.1%).
"""

from __future__ import annotations

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES = 3.35e12


def layer_matmul_params(m: dict) -> int:
  """Weights one token meets in one layer's products."""
  d, h = m["d_model"], m["heads"]
  if m["kind"] == "mla_moe":
    r, nd, rd, vd = (m["kv_lora_rank"], m["qk_nope_dim"], m["qk_rope_dim"],
                     m["v_head_dim"])
    mixer = d * h * (nd + rd) + d * (r + rd) + r * h * (nd + vd) + h * vd * d
  else:
    dh, hkv = m["head_dim"], m["kv_heads"]
    mixer = 2 * d * h * dh + 2 * d * hkv * dh
  f = m["expert_width"]
  ffn = (m["experts_per_token"] + m["shared_experts"]) * 3 * d * f
  return mixer + d * m["experts"] + ffn


def head_params(m: dict) -> int:
  return m["d_model"] * m["vocab"]


def causal_pairs(s: int) -> int:
  return s * (s + 1) // 2


def attention_flops(m: dict, pairs: int) -> int:
  """Forward QK^T and PV products over ``pairs`` (query, key) pairs of one
  sequence, all layers."""
  if m["kind"] == "mla_moe":
    d_qk, d_v = m["qk_nope_dim"] + m["qk_rope_dim"], m["v_head_dim"]
  else:
    d_qk = d_v = m["head_dim"]
  return 2 * m["heads"] * pairs * (d_qk + d_v) * m["layers"]


def train_step_flops(m: dict, sequences: int, seq: int) -> int:
  """Model FLOPs of one training step over ``sequences`` x ``seq``
  tokens: 3 x (2 N tokens + the causal attention products)."""
  n = m["layers"] * layer_matmul_params(m) + head_params(m)
  fwd = 2 * n * sequences * seq + sequences * attention_flops(
      m, causal_pairs(seq))
  return 3 * fwd


def prefill_flops(m: dict, length: int) -> int:
  """One prompt's prefill: every position through the layers, the head
  at the last position only (the step returns the last logits)."""
  return (2 * m["layers"] * layer_matmul_params(m) * length
          + 2 * head_params(m) + attention_flops(m, causal_pairs(length)))


def decode_step_flops(m: dict, batch: int, pos: int) -> int:
  """One decode step of ``batch`` tokens at position ``pos`` (each
  attends to pos + 1 keys)."""
  n = m["layers"] * layer_matmul_params(m) + head_params(m)
  return 2 * n * batch + batch * attention_flops(m, pos + 1)


def decode_step_bytes(m: dict, batch: int, pos: int) -> int:
  """Bytes a decode step must move: every weight once (the batch meets
  all experts), the embedding rows of the batch's tokens, the cache up to
  ``pos`` read and the new position written, the f32 logits written."""
  dt = 2 if m["dtype"] == "bfloat16" else 4
  d = m["d_model"]
  n = m["layers"] * weights_per_layer(m) + head_params(m)
  kv = 2 * m["kv_heads"] * m["head_dim"] * m["layers"] * batch
  return ((n + batch * d + kv * (pos + 1)) * dt
          + batch * m["vocab"] * 4)


def weights_per_layer(m: dict) -> int:
  """Every weight of one layer: its mixer, router, all experts."""
  d, f = m["d_model"], m["expert_width"]
  routed = m["experts_per_token"] * 3 * d * f
  return (layer_matmul_params(m) - routed
          + 3 * m["experts"] * d * f)


def flash_least_s(b: int, sq: int, h: int, hkv: int, d: int, dv: int,
                  causal: bool = True) -> float:
  """Least time of one attention kernel launch, as ``chip_smoke.py``'s
  ``attn_bound`` (the kernel table's bound column): bytes (q, k, v read
  once, the bf16 output written once) against the bf16 products over the
  pairs it computes plus 5 f32 operations a score for the softmax."""
  pairs = causal_pairs(sq) if causal else sq * sq
  n_bytes = (b * sq * h * (d + dv) + b * sq * hkv * (d + dv)) * 2
  flops = 2 * b * h * pairs * (d + dv)
  ops_s = flops / BF16_FLOPS + 5 * b * h * pairs / F32_FLOPS
  return max(n_bytes / HBM_BYTES, ops_s)
