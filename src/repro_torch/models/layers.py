"""Shared model layers: RMSNorm, RoPE, SwiGLU MLP, embedding, LM head, loss.

Counterpart of ``repro.models.layers``, for the layers the MLA + MoE
serving and training paths run; attention is
``repro_torch.kernels.flash_attention``, which dispatches by device itself.
Parameters are plain dicts of tensors in the JAX layouts (``w_in`` (d, f),
``table`` (V, d), ...), so the same pytree maps one to one.  The
reference's ``shard_activation`` calls are dropped: the port runs on one
card, and without sharding rules that call is the identity in the
reference too (``repro.sharding.specs.shard_activation``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = dict[str, torch.Tensor]


def not_ported(what: str, item: str) -> NotImplementedError:
  return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, queue "
                             f"1: {item})")


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_apply(p: Params, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
  """RMSNorm in f32, returned in the input's dtype."""
  if kind != "rmsnorm":
    raise not_ported(f"norm {kind!r}", "other layer kinds")
  xf = x.to(torch.float32)
  ms = torch.mean(xf * xf, dim=-1, keepdim=True)
  return (xf * torch.rsqrt(ms + eps) * p["scale"]).to(x.dtype)


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


def mlp_apply(p: Params, x: torch.Tensor, variant: str) -> torch.Tensor:
  """SwiGLU MLP: (silu(x w_gate) * x w_in) w_out."""
  if variant != "swiglu":
    raise not_ported(f"MLP variant {variant!r}", "other layer kinds")
  h = torch.einsum("...d,df->...f", x, p["w_in"])
  g = torch.einsum("...d,df->...f", x, p["w_gate"])
  return torch.einsum("...f,fd->...d", F.silu(g) * h, p["w_out"])


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
