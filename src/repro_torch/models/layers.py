"""Shared model layers: RMSNorm and LayerNorm, RoPE, the SwiGLU, GeGLU and
GELU MLPs, GQA attention with an optional sliding window, embedding, LM
head, loss.

Counterpart of ``repro.models.layers``, for the layers the port's layer
kinds run: the ``mla_moe`` kind (deepseek-v2-lite) uses the norm, RoPE,
the shared experts' MLP and the head; the ``dense`` kind (llama3.2-1b,
tinyllama-1.1b) adds GQA attention (``attn_*``, ``decode_attention``) and
the SwiGLU MLP; the ``local`` and ``global`` kinds (gemma3-12b) the GeGLU
MLP and, for ``local``, the sliding window; stablelm-3b's ``dense`` layers
LayerNorm and the non-gated GELU MLP.  Sequence attention is
``repro_torch.kernels.flash_attention``, which dispatches by device itself.
Parameters are plain dicts of tensors in the JAX layouts (``w_in`` (d, f),
``wq`` (d, h, dh), ``table`` (V, d), ...), so the same pytree maps one to
one.  The reference's ``shard_activation`` calls are dropped: the port runs
on one card, and without sharding rules that call is the identity in the
reference too (``repro.sharding.specs.shard_activation``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import flash_attention as _fa

Params = dict[str, torch.Tensor]

_NEG_INF = -1e30


def not_ported(what: str, item: str) -> NotImplementedError:
  return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, queue "
                             f"1: {item})")


def normal(gen: torch.Generator, shape, scale: float, dtype,
           device) -> torch.Tensor:
  """N(0, 1) * scale, drawn in ``dtype`` on ``device`` (no f32 copy)."""
  return torch.randn(shape, generator=gen, dtype=dtype,
                     device=device).mul_(scale)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


NORMS = ("rmsnorm", "layernorm")


def norm_init(d: int, kind: str, device=None) -> Params:
  """A norm's f32 leaves: the scale (ones) and, for LayerNorm, the bias
  (zeros)."""
  if kind not in NORMS:
    raise ValueError(f"unknown norm {kind!r}; the norms are {NORMS}")
  p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
  if kind == "layernorm":
    p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
  return p


def norm_apply(p: Params, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
  """RMSNorm or LayerNorm in f32, returned in the input's dtype.  The
  LayerNorm's variance is the population one (``jnp.var``'s, divided by
  n), not PyTorch's default n - 1."""
  if kind not in NORMS:
    raise ValueError(f"unknown norm {kind!r}; the norms are {NORMS}")
  xf = x.to(torch.float32)
  if kind == "layernorm":
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
  else:
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(ms + eps) * p["scale"]
  return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor | int,
         theta: float) -> torch.Tensor:
  """x: (..., S, H, D) with positions (S,), or (..., H, D) with one
  position as an int; rotates the two halves of the last axis.  (A Python
  int keeps decode free of a host-to-device copy, which would make the
  host wait for the card in every layer.)"""
  d = x.shape[-1]
  half = d // 2
  freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                 device=x.device) / half)
  if isinstance(positions, int):
    ang = freq * float(positions)                        # (half,)
  else:
    ang = positions[..., None].to(torch.float32) * freq  # (..., S, half)
  cos = torch.cos(ang)[..., None, :]                     # over heads
  sin = torch.sin(ang)[..., None, :]
  x1, x2 = x[..., :half], x[..., half:]
  out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
  return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def _gelu(x: torch.Tensor) -> torch.Tensor:
  """The tanh-approximated gelu (the reference's ``approximate=True``)."""
  return F.gelu(x, approximate="tanh")


# The gated MLP variants: the same three weights, the gate's activation.
GATED = {"swiglu": F.silu, "geglu": _gelu}
MLPS = (*GATED, "gelu")


def mlp_init(gen: torch.Generator, d: int, f: int, variant: str, dtype,
             device) -> Params:
  """The MLP's weights with the reference's scales, 1/sqrt(d) in and
  1/sqrt(f) out, drawn w_in, w_out, then w_gate for a gated variant (the
  non-gated GELU has none)."""
  if variant not in MLPS:
    raise ValueError(f"unknown MLP variant {variant!r}; the variants are "
                     f"{MLPS}")
  si, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
  p = {"w_in": normal(gen, (d, f), si, dtype, device),
       "w_out": normal(gen, (f, d), so, dtype, device)}
  if variant in GATED:
    p["w_gate"] = normal(gen, (d, f), si, dtype, device)
  return p


def mlp_apply(p: Params, x: torch.Tensor, variant: str) -> torch.Tensor:
  """Gated MLP (act(x w_gate) * x w_in) w_out, act silu (SwiGLU) or the
  tanh-approximated gelu (GeGLU); or the GELU MLP gelu(x w_in) w_out."""
  if variant not in MLPS:
    raise ValueError(f"unknown MLP variant {variant!r}; the variants are "
                     f"{MLPS}")
  h = torch.einsum("...d,df->...f", x, p["w_in"])
  if variant in GATED:
    g = torch.einsum("...d,df->...f", x, p["w_gate"])
    h = GATED[variant](g) * h
  else:
    h = _gelu(h)
  return torch.einsum("...f,fd->...d", h, p["w_out"])


# ---------------------------------------------------------------------------
# GQA attention layer (params + train/prefill/decode)
# ---------------------------------------------------------------------------


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int,
                     window: int = 0, softcap: float = 0.0) -> torch.Tensor:
  """Single-token attention. q: (B,H,D); caches: (B,S,Hkv,D) -> (B,H,D).

  A masked softmax over the full-length cache (positions below
  ``cache_len`` and, with ``window > 0``, above ``cache_len - 1 - window``),
  the G = H / Hkv query heads of a kv head together; scores in f32 (with
  ``softcap`` c > 0, c * tanh(s / c) before the mask), the weights cast to
  the values' dtype, as in the reference (plain ops there too: no kernel).
  """
  b, h, d = q.shape
  s, hkv = k_cache.shape[1:3]
  g = h // hkv
  qg = q.reshape(b, hkv, g, d)
  scores = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache).to(torch.float32)
  scores = scores * (1.0 / math.sqrt(d))
  if softcap > 0.0:
    scores = torch.tanh(scores / softcap) * softcap
  pos = torch.arange(s, device=q.device)
  valid = pos < cache_len
  if window > 0:
    valid &= pos > cache_len - 1 - window
  scores = torch.where(valid, scores,
                       torch.full((), _NEG_INF, device=q.device))
  p = torch.softmax(scores, dim=-1)
  o = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype), v_cache)
  return o.reshape(b, h, v_cache.shape[-1])


def attn_init(cfg, gen: torch.Generator, dtype, device) -> Params:
  """wq (d, h, dh), wk / wv (d, hkv, dh), wo (h, dh, d), with the
  reference's scales."""
  d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
  si, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(h * dh)
  return {"wq": normal(gen, (d, h, dh), si, dtype, device),
          "wk": normal(gen, (d, hkv, dh), si, dtype, device),
          "wv": normal(gen, (d, hkv, dh), si, dtype, device),
          "wo": normal(gen, (h, dh, d), so, dtype, device)}


def attn_apply_seq(p: Params, x: torch.Tensor, positions: torch.Tensor, cfg,
                   *, window: int = 0, return_kv: bool = False):
  """Full-sequence causal GQA attention (train / prefill), over the last
  ``window`` positions where ``window > 0``. x: (B,S,d) -> (B,S,d) [, (k,
  v) of (B,S,Hkv,dh), k after RoPE: the cache]."""
  q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
  k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
  v = torch.einsum("bsd,dhk->bshk", x, p["wv"]).contiguous()
  q = rope(q, positions, cfg.rope_theta)
  k = rope(k, positions, cfg.rope_theta)
  o = _fa.flash_attention(q, k, v, causal=True, window=window,
                          q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
  out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
  if return_kv:
    return out, (k, v)
  return out


def attn_apply_decode(p: Params, x: torch.Tensor, cache: Params, pos: int,
                      cfg, *, window: int = 0):
  """One-token step. x: (B,d); cache {k, v}: (B,S,Hkv,dh); ``window`` as in
  ``decode_attention``.

  Writes the token's k and v into ``cache`` at ``pos`` in place (the
  reference returns updated copies) and returns (out (B,d), cache).
  """
  q = torch.einsum("bd,dhk->bhk", x, p["wq"])
  k = torch.einsum("bd,dhk->bhk", x, p["wk"])
  v = torch.einsum("bd,dhk->bhk", x, p["wv"])
  q = rope(q, pos, cfg.rope_theta)
  k = rope(k, pos, cfg.rope_theta)
  cache["k"][:, pos] = k.to(cache["k"].dtype)
  cache["v"][:, pos] = v.to(cache["v"].dtype)
  o = decode_attention(q, cache["k"], cache["v"], pos + 1, window)
  return torch.einsum("bhk,hkd->bd", o, p["wo"]), cache


def attn_init_cache(cfg, batch: int, max_len: int, dtype,
                    device=None) -> Params:
  shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
  return {"k": torch.zeros(shape, dtype=dtype, device=device),
          "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Embedding + LM head
# ---------------------------------------------------------------------------


def embed_apply(p: Params, tokens: torch.Tensor,
                scale: bool = False) -> torch.Tensor:
  out = p["table"][tokens]
  if scale:
    out = out * math.sqrt(out.shape[-1])
  return out


def lm_head_logits(w: torch.Tensor, x: torch.Tensor,
                   softcap: float = 0.0) -> torch.Tensor:
  logits = torch.einsum("...d,dv->...v", x, w).to(torch.float32)
  if softcap > 0.0:
    logits = torch.tanh(logits / softcap) * softcap
  return logits


def _chunk_nll(w: torch.Tensor, x: torch.Tensor, targets: torch.Tensor,
               softcap: float) -> torch.Tensor:
  logits = lm_head_logits(w, x, softcap)
  logz = torch.logsumexp(logits, dim=-1)
  gold = torch.gather(logits, -1, targets[..., None])[..., 0]
  return logz - gold


def lm_loss_chunked(w: torch.Tensor, x: torch.Tensor, targets: torch.Tensor,
                    *, chunk: int = 1024, softcap: float = 0.0
                    ) -> torch.Tensor:
  """Per-token NLL (B, S) in f32 without materializing (B, S, V).

  The sequence is cut into chunks of the largest divisor of S not above
  ``chunk`` (the reference's scan); each chunk runs under
  ``torch.utils.checkpoint``, so backward recomputes its f32 logits and
  only one chunk's are alive at a time (420 MB at V = 102400 and a chunk
  of 1024 tokens).
  """
  b, s, _ = x.shape
  chunk = min(chunk, s)
  while s % chunk:
    chunk -= 1
  return torch.cat([
      checkpoint(_chunk_nll, w, x[:, i:i + chunk], targets[:, i:i + chunk],
                 softcap, use_reentrant=False)
      for i in range(0, s, chunk)], dim=1)
