"""Flash attention forward: the CUDA kernel and its plain version.

Counterpart of ``repro.kernels.flash_attention`` (the TPU kernel) and of
the chunked attention in ``repro.models.layers.flash_attention``, in the
JAX layout: q (B, Sq, H, D), k (B, Skv, Hkv, D), v (B, Skv, Hkv, Dv),
output (B, Sq, H, Dv), with H = G * Hkv (GQA) and scale 1 / sqrt(D).

* ``flash_attention``: the one entry point the models call.  On a CUDA
  tensor, the hand-written kernel in ``csrc/flash_attention.cu`` (bf16, f32
  softmax state, tensor cores; see the note there); on a CPU tensor, the
  plain version with every option.  Each kernel launch adds one to
  ``LAUNCHES["flash_attention"]``.
* ``flash_attention_plain``: the reference's chunked online-softmax
  attention in plain PyTorch, on any device, with its dtype behaviour:
  scores and block outputs in the input dtype, the running max and sum in
  f32.  It also has the reference's sliding window, logit soft-cap and
  query offset, which the kernel does not take (none is on the serving
  path; on the card they raise).
* ``compare_with_plain``: the kernel's error model, held against the
  plain version in f32 on the same inputs.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

# Launch count of the kernel; only the wrapper below increments it.
LAUNCHES = {"flash_attention": 0}
KERNEL_WIDTHS = ((192, 128),)   # (D, Dv) built: the MLA widths
ROWS_PER_BLOCK = 128   # query rows of one block: G must divide it

_NEG_INF = -1e30


def reset_launches() -> None:
  LAUNCHES["flash_attention"] = 0


# ---------------------------------------------------------------------------
# Plain version: repro.models.layers.flash_attention in PyTorch.
# ---------------------------------------------------------------------------


def _attend_block(q, k, v, mask, scale, softcap):
  """q: (B,cq,Hkv,G,D)  k/v: (B,ckv,Hkv,D)  mask: (cq,ckv) bool."""
  s = torch.einsum("bqhgd,bkhd->bhgqk", q, k).to(torch.float32) * scale
  if softcap > 0.0:
    s = torch.tanh(s / softcap) * softcap
  s = torch.where(mask[None, None, None], s,
                  torch.full((), _NEG_INF, dtype=s.dtype, device=s.device))
  m = torch.amax(s, dim=-1)                          # (B,Hkv,G,cq)
  p = torch.exp(s - m[..., None])
  l = torch.sum(p, dim=-1)
  o = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype), v)
  return m, l, o


def _merge(m1, l1, o1, m2, l2, o2):
  m = torch.maximum(m1, m2)
  a1 = torch.exp(m1 - m)
  a2 = torch.exp(m2 - m)
  l = l1 * a1 + l2 * a2
  o = o1 * a1[..., None].to(o1.dtype) + o2 * a2[..., None].to(o2.dtype)
  return m, l, o


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          q_chunk: int = 512, kv_chunk: int = 1024,
                          softcap: float = 0.0,
                          q_offset: int = 0) -> torch.Tensor:
  """Chunked attention. q: (B,Sq,H,D); k,v: (B,Skv,Hkv,D|Dv) -> (B,Sq,H,Dv).

  ``q_offset``: global position of q[0] relative to k[0].  With
  ``window > 0`` only the kv blocks inside the window are visited;
  otherwise all kv blocks are, with causal masking.
  """
  b, sq, h, d = q.shape
  _, skv, hkv, _ = k.shape
  dv = v.shape[-1]
  g = h // hkv
  scale = 1.0 / math.sqrt(d)
  q_chunk = min(q_chunk, sq)
  kv_chunk = min(kv_chunk, skv)
  while sq % q_chunk:
    q_chunk -= 1
  while skv % kv_chunk:
    kv_chunk -= 1
  nq, nkv = sq // q_chunk, skv // kv_chunk
  qg = q.reshape(b, sq, hkv, g, d)
  dev = q.device
  blocks = []
  for qi in range(nq):
    q_blk = qg[:, qi * q_chunk:(qi + 1) * q_chunk]
    q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
    m = torch.full((b, hkv, g, q_chunk), _NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, hkv, g, q_chunk), dtype=torch.float32, device=dev)
    o = torch.zeros((b, hkv, g, q_chunk, dv), dtype=v.dtype, device=dev)
    if window > 0:
      # Visit only the blocks overlapping [q_lo - window + 1, q_hi].
      first = (q_offset + qi * q_chunk - window) // kv_chunk
      visits = [(min(max(first + j, 0), nkv - 1), first + j >= 0)
                for j in range(window // kv_chunk + 2)]
    else:
      visits = [(j, True) for j in range(nkv)]
    for blk, valid in visits:
      k_blk = k[:, blk * kv_chunk:(blk + 1) * kv_chunk]
      v_blk = v[:, blk * kv_chunk:(blk + 1) * kv_chunk]
      kv_pos = blk * kv_chunk + torch.arange(kv_chunk, device=dev)
      if window > 0:
        mask = ((kv_pos[None, :] <= q_pos[:, None])
                & (kv_pos[None, :] > q_pos[:, None] - window)
                & valid)
      elif causal:
        mask = kv_pos[None, :] <= q_pos[:, None]
      else:
        mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool, device=dev)
      m, l, o = _merge(m, l, o,
                       *_attend_block(q_blk, k_blk, v_blk, mask, scale,
                                      softcap))
    out = o / torch.clamp(l, min=1e-30)[..., None].to(o.dtype)
    blocks.append(out.permute(0, 3, 1, 2, 4))        # (B,cq,Hkv,G,Dv)
  return torch.cat(blocks, dim=1).reshape(b, sq, h, dv)


# ---------------------------------------------------------------------------
# CUDA kernel.
# ---------------------------------------------------------------------------


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
  for name, t in (("q", q), ("k", k), ("v", v)):
    if t.device != q.device:
      raise ValueError(f"flash_attention: q on {q.device}, {name} on "
                       f"{t.device}")
    if t.dtype != torch.bfloat16:
      raise TypeError(f"the flash_attention kernel takes bf16; {name} is "
                      f"{t.dtype}")
    if t.dim() != 4:
      raise ValueError(f"flash_attention takes 4-D tensors; {name} has "
                       f"shape {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
      raise ValueError(f"flash_attention takes contiguous, 16-byte aligned "
                       f"tensors; {name} is not")
  b, sq, h, d = q.shape
  _, skv, hkv, dv = v.shape
  if k.shape != (b, skv, hkv, d) or v.shape[:3] != (b, skv, hkv):
    raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                     f"{tuple(k.shape)}, v {tuple(v.shape)} do not match "
                     "(B,Sq,H,D), (B,Skv,Hkv,D), (B,Skv,Hkv,Dv)")
  if h % hkv or ROWS_PER_BLOCK % (h // hkv):
    raise ValueError(f"flash_attention: H = {h} must be a multiple G of "
                     f"Hkv = {hkv}, with G dividing {ROWS_PER_BLOCK}")
  if (d, dv) not in KERNEL_WIDTHS:
    raise ValueError(f"flash_attention: (D, Dv) = {(d, dv)} is not built; "
                     f"the kernel has {KERNEL_WIDTHS}")
  if skv == 0:
    raise ValueError("flash_attention: no keys (Skv = 0)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, *, window: int = 0,
                    q_chunk: int = 512, kv_chunk: int = 1024,
                    softcap: float = 0.0,
                    q_offset: int = 0) -> torch.Tensor:
  """Fused attention forward. q: (B,Sq,H,D); k, v: (B,Skv,Hkv,D|Dv).

  A CUDA tensor runs the kernel (bf16 only; ``q_chunk`` and ``kv_chunk``
  are the plain version's chunking and do not apply); a CPU tensor the
  plain version; any other device raises.
  """
  if q.device.type == "cpu":
    return flash_attention_plain(
        q, k, v, causal=causal, window=window, q_chunk=q_chunk,
        kv_chunk=kv_chunk, softcap=softcap, q_offset=q_offset)
  if q.device.type != "cuda":
    raise ValueError(f"flash_attention takes CPU or CUDA tensors; got "
                     f"{q.device}")
  if window > 0 or softcap > 0.0 or q_offset != 0:
    raise NotImplementedError(
        "attention with a sliding window, logit soft-cap or query offset "
        "on the card is not ported yet (ROADMAP.md, queue 1: "
        "window/softcap attention)")
  _check(q, k, v)
  b, sq, h, d = q.shape
  _, skv, hkv, dv = v.shape
  out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
  launch = _build.entry(
      "flash_attention", "flash_attention_launch",
      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
      + [ctypes.c_float, ctypes.c_void_p])
  with _build.on_device(q.device):
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
        skv, h, hkv, d, dv, int(causal), 1.0 / math.sqrt(d),
        _build.current_stream(q.device))
  if err != 0:
    raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                       f"error {err}")
  LAUNCHES["flash_attention"] += 1
  return out


# ---------------------------------------------------------------------------
# Error model of the kernel.
# ---------------------------------------------------------------------------

# Unit roundoff of bf16 (8 significant bits).
BF16_U = 2.0**-8
# Limit on ||kernel - plain||_F / ||plain||_F.  The two roundings below are
# independent from element to element, each about 2**-8 / sqrt(12) of an
# element's size on average, so the ratio sits near 2e-3; an error that is
# systematic over a share of the rows (a mask one key off, a mis-scaled kv
# tile) raises it by an order of magnitude.
REL_FROB_LIMIT = 2.0**-7


def compare_with_plain(out: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, causal: bool) -> dict[str, float]:
  """The kernel's output against the plain version in f32 on the same bf16
  inputs.

  The kernel rounds P to bf16 for the P V product and the output to bf16,
  each a relative error of at most BF16_U; its f32 scores, exponentials and
  sums add errors near 1e-6.  So element (i, c) is off by at most
  BF16_U * (|ref_ic| + A_ic), with A = the same attention over |v| (the
  softmax-weighted mean of |v_jc|).  ``tol_ratio`` is the largest
  |out - ref| / (2 * BF16_U * (|ref| + A)), at most 1 for a right kernel;
  ``rel_frob`` is the relative Frobenius error, at most REL_FROB_LIMIT;
  ``median_ref`` is the median |ref|, the scale that both sit against.
  """
  qf, kf, vf = q.float(), k.float(), v.float()
  ref = flash_attention_plain(qf, kf, vf, causal=causal)
  a = flash_attention_plain(qf, kf, vf.abs(), causal=causal)
  err = (out.float() - ref).abs()
  tol = torch.clamp(2 * BF16_U * (ref.abs() + a), min=1e-30)
  return {
      "finite": bool(torch.isfinite(out).all()),
      "max_abs_err": float(err.max()),
      "tol_ratio": float((err / tol).max()),
      "rel_frob": float(torch.linalg.vector_norm(err)
                        / torch.linalg.vector_norm(ref)),
      "median_ref": float(ref.abs().median()),
  }
