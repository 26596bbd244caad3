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
one.  The reference's ``shard_activation`` calls stand at its points (the
identity without sharding rules), and the products are
``repro_torch.sharding.local.einsum`` (``torch.einsum`` itself on plain
tensors), so the same code runs on DTensors under a mesh.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.obs.tracing import span
from repro_torch.sharding import local as _local
from repro_torch.sharding.local import einsum, write_positions
from repro_torch.sharding.specs import shard_activation

Params = dict[str, torch.Tensor]


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
  if isinstance(x, DTensor):
    # The statistics take the whole feature dim on each rank.
    x = _local.to_placements(x, _local.keep_placements(x, range(x.dim() - 1)))
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
  if isinstance(positions, int) and x.device.type == "cuda":
    cos, sin = _rope_angles(half, float(theta), positions, x.device,
                            torch.is_inference_mode_enabled())
  else:
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    if isinstance(positions, int):
      ang = freq * float(positions)                        # (half,)
    else:
      ang = positions[..., None].to(torch.float32) * freq  # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
  cos = cos[..., None, :]                                  # over heads
  sin = sin[..., None, :]
  x1, x2 = x[..., :half], x[..., half:]
  out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
  return out.to(x.dtype)


@functools.lru_cache(maxsize=64)
def _rope_angles(half: int, theta: float, pos: int, device: torch.device,
                 inference: bool) -> tuple[torch.Tensor, torch.Tensor]:
  """cos and sin (half,) of one position's angles on a CUDA device, by the
  same ops as ``rope``'s, made once and shared by the q and k of every
  layer of a decode step: each ``rope`` call would otherwise launch six
  kernels more, ~1 ms of the host's time in a grok-1 decode step of 6
  layers, which the host must keep below the card's.  Keyed by inference
  mode too, so that a tensor made under it never meets autograd."""
  del inference
  freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                 device=device) / half)
  ang = freq * float(pos)
  return torch.cos(ang), torch.sin(ang)


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
  h = einsum("...d,df->...f", x, p["w_in"])
  if variant in GATED:
    g = einsum("...d,df->...f", x, p["w_gate"])
    h = GATED[variant](g) * h
  else:
    h = _gelu(h)
  if h.dim() == 3:
    h = shard_activation(h, "ffn")
  return einsum("...f,fd->...d", h, p["w_out"])


# ---------------------------------------------------------------------------
# GQA attention layer (params + train/prefill/decode)
# ---------------------------------------------------------------------------


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int,
                     window: int = 0, softcap: float = 0.0) -> torch.Tensor:
  """Single-token attention. q: (B,H,D); caches: (B,S,Hkv,D) -> (B,H,D).

  Attention over the valid cache positions (below ``cache_len`` and, with
  ``window > 0``, above ``cache_len - 1 - window``), the G = H / Hkv query
  heads of a kv head together; scores in f32 (with ``softcap`` c > 0,
  c * tanh(s / c) before the mask).  On CUDA tensors the split-KV kernel
  ``kernels/decode_attention.py`` (``csrc/decode_attention.cu``), which
  reads only the valid positions, in place; on CPU tensors its plain
  version, the reference's masked softmax over the full-length cache with
  the weights cast to the values' dtype (plain ops there: the reference has
  no kernel).  Runs in the span ``repro_decode_attention``.
  """
  with span("repro_decode_attention"):
    if isinstance(k_cache, DTensor):
      return _decode_attention_sharded(q, k_cache, v_cache, cache_len,
                                       window, softcap)
    o, _ = _da.decode_block(q, k_cache, v_cache, 0, cache_len, window,
                            softcap)
    return o


def _decode_attention_sharded(q, k_cache: DTensor, v_cache: DTensor,
                              cache_len: int, window: int,
                              softcap: float) -> DTensor:
  """``decode_attention`` on the caches' blocks, which stay where they
  are: batch over the mesh dims that split the caches' batch, heads where
  they split the kv heads (q's heads alike), and the positions where they
  split the sequence.  There each rank attends over its positions
  (``decode_block``, the kernel on CUDA blocks) and the blocks' outputs
  are combined by their rows' log-sum-exp, with weights exp(lse_i - lse)
  (FlashDecoding's combine) through a max and a sum over those mesh dims;
  one block's weight is 1, a block with no valid position weighs 0."""
  mesh = k_cache.device_mesh
  pl = k_cache.placements
  qp = tuple(Shard(0) if p == Shard(0) else Shard(1) if p == Shard(2)
             else Replicate() for p in pl)
  if not isinstance(q, DTensor):
    q = DTensor.from_local(q, mesh, [Replicate()] * mesh.ndim)
  ql = _local.to_placements(q, qp).to_local()
  vl = v_cache.to_local()
  lo, _ = _local.shard_range(k_cache, 1)
  o, lse = _da.decode_block(ql, k_cache.to_local(), vl, lo, cache_len,
                            window, softcap)
  seq = [i for i, p in enumerate(pl) if p == Shard(1)]
  if not seq:
    return _local.wrap(o, mesh, qp)
  return _local.wrap(combine_blocks(
      o, lse, lambda local, op: _local.to_placements(
          _local.wrap(local, mesh, [Partial(op) if i in seq else p
                                    for i, p in enumerate(qp)]),
          qp).to_local()), mesh, qp)


def combine_blocks(o: torch.Tensor, lse: torch.Tensor, reduce) -> torch.Tensor:
  """One rank's block output o (B,H,Dv) with its rows' lse (B,H), combined
  with the other blocks' by ``reduce(local, "max" | "sum")`` (the
  reduction over the blocks): sum_i exp(lse_i - m) o_i / sum_i exp(lse_i -
  m), m the largest lse; in f32, returned in o's dtype."""
  m = reduce(lse, "max")
  mass = torch.exp(lse - m)                  # 0 for a block with lse -inf
  weight = (mass / reduce(mass, "sum"))[..., None]
  return reduce(o.to(torch.float32) * weight, "sum").to(o.dtype)


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
  q = einsum("bsd,dhk->bshk", x, p["wq"])
  k = einsum("bsd,dhk->bshk", x, p["wk"])
  v = einsum("bsd,dhk->bshk", x, p["wv"]).contiguous()
  q = shard_activation(rope(q, positions, cfg.rope_theta), "heads")
  k = shard_activation(rope(k, positions, cfg.rope_theta), "heads")
  o = _fa.flash_attention(q, k, v, causal=True, window=window,
                          q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
  out = einsum("bshk,hkd->bsd", o, p["wo"])
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
  q = einsum("bd,dhk->bhk", x, p["wq"])
  k = einsum("bd,dhk->bhk", x, p["wk"])
  v = einsum("bd,dhk->bhk", x, p["wv"])
  q = rope(q, pos, cfg.rope_theta)
  k = rope(k, pos, cfg.rope_theta)
  write_positions(cache["k"], pos, k[:, None])
  write_positions(cache["v"], pos, v[:, None])
  o = decode_attention(q, cache["k"], cache["v"], pos + 1, window)
  return einsum("bhk,hkd->bd", o, p["wo"]), cache


def attn_init_cache(cfg, batch: int, max_len: int, dtype,
                    device=None) -> Params:
  shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
  return {"k": torch.zeros(shape, dtype=dtype, device=device),
          "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Embedding + LM head
# ---------------------------------------------------------------------------


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> Params:
  """The embedding table (vocab, d), N(0, 0.02^2) from ``gen``, as the
  reference's ``embed_init`` draws it."""
  return {"table": normal(gen, (vocab, d), 0.02, dtype, device)}


def _embed_on_blocks(table: DTensor, tokens: torch.Tensor) -> DTensor:
  """``table[tokens]`` of a DTensor table (Megatron's vocab-parallel
  embedding): the table keeps its vocabulary blocks and gathers its
  features (FSDP's gather at use); the tokens keep their batch split and
  are whole where the table splits the vocabulary; each rank looks up the
  tokens its block holds, zeros for the rest, and the blocks' rows are
  summed.  At one rank the plain lookup, bit for bit."""
  mesh = table.device_mesh
  tab_pl = tuple(p if p == Shard(0) else Replicate()
                 for p in table.placements)
  table = _local.to_placements(table, tab_pl)
  if not isinstance(tokens, DTensor):
    tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim)
  tok_pl = tuple(p if isinstance(p, Shard) and tp != Shard(0) else Replicate()
                 for p, tp in zip(tokens.placements, tab_pl))
  tokens = _local.to_placements(tokens, tok_pl)
  grad_pl = tuple(tp if tp == Shard(0) else
                  Partial() if isinstance(p, Shard) else Replicate()
                  for p, tp in zip(tok_pl, tab_pl))
  lo, hi = _local.shard_range(table, 0)
  t = tokens.to_local()
  local = table.to_local(grad_placements=grad_pl)
  rows = local[torch.clamp(t - lo, 0, hi - lo - 1)]
  rows = torch.where(((t >= lo) & (t < hi))[..., None], rows,
                     torch.zeros((), dtype=rows.dtype, device=rows.device))
  return _local.wrap(rows, mesh, [Partial() if tp == Shard(0) else p
                                  for p, tp in zip(tok_pl, tab_pl)])


def embed_apply(p: Params, tokens: torch.Tensor,
                scale: bool = False) -> torch.Tensor:
  if isinstance(p["table"], DTensor):
    out = _embed_on_blocks(p["table"], tokens)
  else:
    out = p["table"][tokens]
  if scale:
    out = out * math.sqrt(out.shape[-1])
  return out


def lm_head_logits(w: torch.Tensor, x: torch.Tensor,
                   softcap: float = 0.0) -> torch.Tensor:
  logits = einsum("...d,dv->...v", x, w).to(torch.float32)
  if softcap > 0.0:
    logits = torch.tanh(logits / softcap) * softcap
  return logits


def _chunk_nll(w: torch.Tensor, x: torch.Tensor, targets: torch.Tensor,
               softcap: float) -> torch.Tensor:
  logits = shard_activation(lm_head_logits(w, x, softcap), "logits")
  if isinstance(logits, DTensor):
    return _nll_vocab_parallel(logits, targets)
  logz = torch.logsumexp(logits, dim=-1)
  gold = torch.gather(logits, -1, targets[..., None])[..., 0]
  return logz - gold


def _nll_vocab_parallel(logits: DTensor, targets: torch.Tensor) -> DTensor:
  """``_chunk_nll``'s NLL of DTensor logits (B, c, V) whose vocabulary may
  be split over mesh axes: each rank takes the log-sum-exp of its vocab
  block and, where the target falls in it, the target's logit; the
  blocks' log-sum-exps are gathered (B x c a rank) and combined, the gold
  logits summed.  At one rank it is the plain form's arithmetic."""
  mesh = logits.device_mesh
  vdim = logits.dim() - 1
  logits = _local.to_placements(logits, tuple(
      p if isinstance(p, Shard) else Replicate() for p in logits.placements))
  rows = tuple(p if isinstance(p, Shard) and p.dim < vdim else Replicate()
               for p in logits.placements)
  vocab = [i for i, p in enumerate(logits.placements) if p == Shard(vdim)]
  lo, hi = _local.shard_range(logits, vdim)
  if not isinstance(targets, DTensor):
    targets = DTensor.from_local(targets, mesh, [Replicate()] * mesh.ndim)
  t = _local.to_placements(targets, rows).to_local()
  local = logits.to_local()
  lse = torch.logsumexp(local, dim=-1, keepdim=True)
  idx = torch.clamp(t - lo, 0, hi - lo - 1)[..., None]
  gold = torch.where((t >= lo) & (t < hi),
                     torch.gather(local, -1, idx)[..., 0],
                     torch.zeros((), dtype=local.dtype, device=local.device))
  lse_all = _local.wrap(lse, mesh, [Shard(vdim) if i in vocab else p
                                    for i, p in enumerate(rows)])
  logz = torch.logsumexp(_local.to_placements(lse_all, rows).to_local(),
                         dim=-1)
  gold_all = _local.wrap(gold, mesh, [Partial() if i in vocab else p
                                      for i, p in enumerate(rows)])
  gold = _local.to_placements(gold_all, rows).to_local()
  return _local.wrap(logz - gold, mesh, rows)


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
  if isinstance(x, DTensor):
    # The chunks slice the sequence: only the batch stays split.
    x = _local.to_placements(x, _local.keep_placements(x, (0,)))
  return torch.cat([
      checkpoint(_chunk_nll, w, x[:, i:i + chunk], targets[:, i:i + chunk],
                 softcap, use_reentrant=False)
      for i in range(0, s, chunk)], dim=1)
