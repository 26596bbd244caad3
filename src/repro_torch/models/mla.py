"""Multi-head Latent Attention (DeepSeek-V2) with a compressed KV cache.

Counterpart of ``repro.models.mla``.  Prefill uses the expanded form and
the flash-attention kernel; decode uses the absorbed form: W_uk is folded
into the query, so attention runs directly against the cached latent c_kv
(rank r) and the shared RoPE key, in plain einsums (the reference has no
kernel there either).  Parameters keep the JAX layouts: ``wq`` (d, h,
nd+rd), ``w_dkv`` (d, r+rd), ``w_uk`` / ``w_uv`` (r, h, nd|vd), ``wo``
(h, vd, d).  ``mla_init`` draws them with the reference's scales.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.sharding.local import einsum, write_positions
from repro_torch.sharding.specs import shard_activation
from repro_torch.models.layers import Params, normal, rope

_NEG_INF = -1e30


def mla_init(cfg, gen: torch.Generator, dtype, device) -> Params:
  """wq, w_dkv, w_uk, w_uv, wo, drawn in that order with the reference's
  scales (1/sqrt(d) in, 1/sqrt(r) up, 1/sqrt(h vd) out)."""
  d, h = cfg.d_model, cfg.num_heads
  r, nd, rd, vd = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                   cfg.v_head_dim)
  si, sr = 1.0 / math.sqrt(d), 1.0 / math.sqrt(r)
  return {"wq": normal(gen, (d, h, nd + rd), si, dtype, device),
          "w_dkv": normal(gen, (d, r + rd), si, dtype, device),
          "w_uk": normal(gen, (r, h, nd), sr, dtype, device),
          "w_uv": normal(gen, (r, h, vd), sr, dtype, device),
          "wo": normal(gen, (h, vd, d), 1.0 / math.sqrt(h * vd), dtype,
                       device)}


def mla_apply_seq(p: Params, x: torch.Tensor, positions: torch.Tensor, cfg,
                  *, return_kv: bool = False):
  """Expanded MLA for prefill. x: (B,S,d) -> (B,S,d) [, cache latents]."""
  nd, rd = cfg.qk_nope_dim, cfg.qk_rope_dim
  r = cfg.kv_lora_rank
  q = einsum("bsd,dhk->bshk", x, p["wq"])
  q_nope, q_rope = q[..., :nd], q[..., nd:]
  q_rope = rope(q_rope, positions, cfg.rope_theta)

  ckv_full = einsum("bsd,dr->bsr", x, p["w_dkv"])
  c_kv, k_rope = ckv_full[..., :r], ckv_full[..., r:]
  k_rope = rope(k_rope[..., None, :], positions, cfg.rope_theta)  # (B,S,1,rd)

  k_nope = einsum("bsr,rhk->bshk", c_kv, p["w_uk"])
  v = einsum("bsr,rhk->bshk", c_kv, p["w_uv"])

  h = cfg.num_heads
  k_rope_b = k_rope.expand(k_rope.shape[:2] + (h, rd))
  q_full = torch.cat([q_nope, q_rope], dim=-1)
  k_full = torch.cat([k_nope, k_rope_b], dim=-1)
  q_full = shard_activation(q_full, "heads")
  k_full = shard_activation(k_full, "heads")

  # V stays at v_head_dim: the kernel takes D != Dv.
  o = _fa.flash_attention(q_full.contiguous(), k_full.contiguous(),
                          v.contiguous(), causal=True, q_chunk=cfg.q_chunk,
                          kv_chunk=cfg.kv_chunk)
  out = einsum("bshk,hkd->bsd", o, p["wo"])
  if return_kv:
    return out, {"c_kv": c_kv, "k_rope": k_rope[..., 0, :]}
  return out


def mla_init_cache(cfg, batch: int, max_len: int, dtype,
                   device=None) -> Params:
  return {
      "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                          device=device),
      "k_rope": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                            device=device),
  }


def mla_apply_decode(p: Params, x: torch.Tensor, cache: Params, pos: int,
                     cfg):
  """Absorbed-form decode. x: (B,d); cache latents (B,S,r), (B,S,rd).

  Writes the new token's latents into ``cache`` at ``pos`` in place (the
  reference returns updated copies) and returns (out (B,d), cache).
  """
  nd, rd, r = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
  scale = 1.0 / math.sqrt(nd + rd)
  q = einsum("bd,dhk->bhk", x, p["wq"])
  q_nope, q_rope = q[..., :nd], q[..., nd:]
  q_rope = rope(q_rope, pos, cfg.rope_theta)

  ckv_full = einsum("bd,dr->br", x, p["w_dkv"])
  c_new, kr_new = ckv_full[..., :r], ckv_full[..., r:]
  kr_new = rope(kr_new[..., None, :], pos, cfg.rope_theta)[..., 0, :]
  c_cache, kr_cache = cache["c_kv"], cache["k_rope"]
  write_positions(c_cache, pos, c_new[:, None])
  write_positions(kr_cache, pos, kr_new[:, None])

  # Absorb W_uk into q: q_lat (B,H,r) attends directly to the latents.
  q_lat = einsum("bhk,rhk->bhr", q_nope, p["w_uk"])
  s_lat = einsum("bhr,bsr->bhs", q_lat, c_cache)
  s_rope = einsum("bhk,bsk->bhs", q_rope, kr_cache)
  s = (s_lat + s_rope).to(torch.float32) * scale
  spos = torch.arange(c_cache.shape[1], device=x.device)
  s = torch.where((spos < pos + 1)[None, None], s,
                  torch.full((), _NEG_INF, device=x.device))
  pw = torch.softmax(s, dim=-1)
  # Attend over latents, then decompress once: (B,H,r) @ W_uv.
  o_lat = einsum("bhs,bsr->bhr", pw.to(c_cache.dtype), c_cache)
  o = einsum("bhr,rhk->bhk", o_lat, p["w_uv"])
  out = einsum("bhk,hkd->bd", o, p["wo"])
  return out, cache
