"""Flash attention: the CUDA forward kernel, its backward, plain versions.

Counterpart of ``repro.kernels.flash_attention`` (the TPU kernel) and of
the chunked attention in ``repro.models.layers.flash_attention``, in the
JAX layout: q (B, Sq, H, D), k (B, Skv, Hkv, D), v (B, Skv, Hkv, Dv),
output (B, Sq, H, Dv), with H = G * Hkv (GQA) and scale 1 / sqrt(D).

* ``flash_attention``: the one entry point the models call.  On a CUDA
  tensor, a ``torch.autograd.Function`` whose forward is the hand-written
  kernel in ``csrc/flash_attention.cu`` (bf16, f32 softmax state, tensor
  cores, built for the widths in ``KERNEL_WIDTHS``; see the note there) and
  whose backward is ``flash_attention_bwd``; the kernel takes every
  option of the reference: the causal mask's sliding window (``window``,
  the ``local`` layers' attention; a window is causal whatever ``causal``
  says), the logit soft-cap (``softcap``) and the query offset
  (``q_offset``); on a CPU tensor, the plain version with every option,
  differentiated by autograd.  Each kernel launch adds one to
  ``LAUNCHES["flash_attention"]``.
* ``flash_attention_bwd``: the gradients of q, k and v, as
  FlashAttention-2's backward in PyTorch ops over query and key chunks
  (the reference has no backward kernel: its training attention is the
  autodiff of the chunked attention).  f32 inside, the input dtype out.
* ``flash_attention_plain``: the reference's chunked online-softmax
  attention in plain PyTorch, on any device, with its dtype behaviour:
  scores and block outputs in the input dtype, the running max and sum in
  f32.  Under a window it visits each key chunk that overlaps a query
  chunk's window once; the reference's visits a fixed number of chunks
  from ``q_lo - window``, clipped to the last, and so counts the last
  chunk twice where they run past it (and misses chunks where ``q_chunk``
  exceeds ``kv_chunk``): fault R4 of the reference (ROADMAP.md), which
  gives a wrong result, not another rounding.
* ``compare_with_plain`` / ``compare_bwd_with_plain``: the error models of
  the forward kernel and of the backward, held against the plain version
  (and its autograd) in f32 on the same inputs, options and all.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import _build
from repro_torch.sharding import local as _local

# Launch count of the kernel; only the wrapper below increments it.
LAUNCHES = {"flash_attention": 0}
# The devices whose tensors go to the kernel's launch op.  A caller that
# traces on fake CPU tensors adds "cpu", so that the trace holds the launch
# as the card runs it (the op's fake implementation gives its shape).
KERNEL_DEVICES = {"cuda"}
# (D, Dv) built: the MLA widths (deepseek), the dense GQA head widths of
# llama3.2-1b and tinyllama-1.1b (64), of grok-1 (128), of gemma3-12b and
# recurrentgemma-2b (256) and of stablelm-3b (80, run padded to 128 inside
# the kernel).  Any other width raises on the card.
KERNEL_WIDTHS = ((192, 128), (64, 64), (128, 128), (256, 256), (80, 80))
# Query rows of one block's tile: a work item takes 128 // G query positions
# of G heads each (at G = 6, 21 positions, 126 rows), so G is at most 128.
ROWS_PER_BLOCK = 128

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
  ``window > 0`` (causal whatever ``causal`` says, as in the reference)
  only the kv blocks overlapping [q_lo - window + 1, q_hi] are visited,
  each once; otherwise all kv blocks are, with causal masking.
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
      q_lo = q_offset + qi * q_chunk
      visits = range(max(q_lo - window + 1, 0) // kv_chunk,
                     min((q_lo + q_chunk - 1) // kv_chunk + 1, nkv))
    else:
      visits = range(nkv)
    for blk in visits:
      k_blk = k[:, blk * kv_chunk:(blk + 1) * kv_chunk]
      v_blk = v[:, blk * kv_chunk:(blk + 1) * kv_chunk]
      kv_pos = blk * kv_chunk + torch.arange(kv_chunk, device=dev)
      if window > 0:
        mask = ((kv_pos[None, :] <= q_pos[:, None])
                & (kv_pos[None, :] > q_pos[:, None] - window))
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


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           window: int = 0, q_offset: int = 0) -> None:
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
    if not t.is_contiguous():
      raise ValueError(f"flash_attention takes contiguous tensors; {name} "
                       "is not")
  b, sq, h, d = q.shape
  _, skv, hkv, dv = v.shape
  if k.shape != (b, skv, hkv, d) or v.shape[:3] != (b, skv, hkv):
    raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                     f"{tuple(k.shape)}, v {tuple(v.shape)} do not match "
                     "(B,Sq,H,D), (B,Skv,Hkv,D), (B,Skv,Hkv,Dv)")
  if h % hkv or h // hkv > ROWS_PER_BLOCK:
    raise ValueError(f"flash_attention: H = {h} must be a multiple G of "
                     f"Hkv = {hkv}, with G at most {ROWS_PER_BLOCK}")
  if (d, dv) not in KERNEL_WIDTHS:
    raise ValueError(f"flash_attention: (D, Dv) = {(d, dv)} is not built; "
                     f"the kernel has {KERNEL_WIDTHS}")
  if skv == 0:
    raise ValueError("flash_attention: no keys (Skv = 0)")
  if q_offset < 0:
    raise ValueError(f"flash_attention: q_offset = {q_offset} < 0 leaves "
                     "queries without a key under the causal mask")
  if window > 0 and q_offset + sq - window >= skv:
    raise ValueError(f"flash_attention: under a window of {window} the last "
                     f"query (position {q_offset + sq - 1}) sees none of the "
                     f"{skv} keys")


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: int, softcap: float,
            q_offset: int) -> torch.Tensor:
  """One launch of the forward kernel (``window`` > 0 with ``causal``
  only, 0: none; ``softcap`` 0: none) on CUDA tensors that ``_check``
  passes, 16-byte aligned.  Its fake implementation gives the output's
  shape, with no check: a trace holds the launch at any width."""
  if q.device.type != "cuda":
    raise ValueError(f"the flash_attention kernel runs on CUDA tensors; got "
                     f"{q.device}")
  _check(q, k, v, window=window, q_offset=q_offset)
  for name, t in (("q", q), ("k", k), ("v", v)):
    if t.data_ptr() % 16:
      raise ValueError(f"flash_attention takes 16-byte aligned tensors; "
                       f"{name} is not")
  b, sq, h, d = q.shape
  _, skv, hkv, dv = v.shape
  out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
  launch = _build.entry(
      "flash_attention", "flash_attention_launch",
      [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
      + [ctypes.c_float] * 2 + [ctypes.c_void_p])
  with _build.on_device(q.device):
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
        skv, h, hkv, d, dv, int(causal), int(window), int(q_offset),
        1.0 / math.sqrt(d), float(softcap), _build.current_stream(q.device))
  if err != 0:
    raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                       f"error {err}")
  LAUNCHES["flash_attention"] += 1
  return out


@_launch.register_fake
def _(q, k, v, causal, window, softcap, q_offset):
  return q.new_empty(q.shape[:3] + (v.shape[-1],))


def attention_pairs(sq: int, skv: int, causal: bool, window: int = 0,
                    q_offset: int = 0) -> int:
  """The (query, key) pairs the kernel computes: every pair; or, causal,
  query i at position p = q_offset + i with the min(p + 1, Skv) keys up
  to it, under a window only those above p - window."""
  if not (causal or window > 0):
    return sq * skv
  return sum(min(p + 1, skv) - max(0, p + 1 - window if window > 0 else 0)
             for p in range(q_offset, q_offset + sq))


def attention_flops(q, k, v, causal: bool, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0) -> int:
  """The tensor-core FLOPs of one kernel launch: QK^T and PV over the
  pairs it computes, 2 B H pairs (D + Dv)."""
  b, sq, h, d = q.shape
  return 2 * b * h * attention_pairs(sq, k.shape[1], causal, window,
                                     q_offset) * (d + v.shape[-1])


class _FlashAttention(torch.autograd.Function):
  """The kernel's forward under autograd; the backward recomputes the row
  log-sum-exp from q and k (the kernel does not store it)."""

  @staticmethod
  def forward(ctx, q, k, v, causal, window, softcap, q_offset):
    out = _launch(q, k, v, causal, window, softcap, q_offset)
    ctx.causal = causal
    ctx.opts = dict(window=window, softcap=softcap, q_offset=q_offset)
    ctx.save_for_backward(q, k, v, out)
    return out

  @staticmethod
  def backward(ctx, do):
    q, k, v, out = ctx.saved_tensors
    return (*flash_attention_bwd(q, k, v, out, do, ctx.causal, **ctx.opts),
            None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, *, window: int = 0,
                    q_chunk: int = 512, kv_chunk: int = 1024,
                    softcap: float = 0.0,
                    q_offset: int = 0) -> torch.Tensor:
  """Fused attention forward. q: (B,Sq,H,D); k, v: (B,Skv,Hkv,D|Dv).

  A CUDA tensor runs the kernel (bf16 only; ``q_chunk`` and ``kv_chunk``
  are the plain version's chunking and do not apply; a ``window`` is
  causal, as in the plain version; every query must see a key),
  differentiable through ``flash_attention_bwd``; a CPU tensor the plain
  version; any other device raises.
  """
  if isinstance(q, DTensor):
    return _on_head_shards(q, k, v, causal=causal, window=window,
                           q_chunk=q_chunk, kv_chunk=kv_chunk,
                           softcap=softcap, q_offset=q_offset)
  if q.device.type not in KERNEL_DEVICES:
    if q.device.type == "cpu":
      return flash_attention_plain(
          q, k, v, causal=causal, window=window, q_chunk=q_chunk,
          kv_chunk=kv_chunk, softcap=softcap, q_offset=q_offset)
    raise ValueError(f"flash_attention takes CPU or CUDA tensors; got "
                     f"{q.device}")
  window, q_offset = max(int(window), 0), int(q_offset)
  return _FlashAttention.apply(q, k, v, bool(causal) or window > 0, window,
                               max(float(softcap), 0.0), q_offset)


def _on_head_shards(q: DTensor, k: DTensor, v: DTensor,
                    **opts) -> DTensor:
  """``flash_attention`` on each rank's block of DTensors: the batch split
  where q's batch is, the query heads where q's heads are, the sequence
  and the widths whole; each rank holds the kv heads its query heads read
  under GQA (its block of kv heads where k shards them alike, else the
  slice it needs of replicated ones, whose gradient is then partial).
  Other placements are redistributed first; a split that leaves a rank's
  query heads reading kv heads out of GQA's order raises."""
  mesh = q.device_mesh
  qp = _local.keep_placements(q, (0, 2))
  kvp = tuple(
      p if p == Shard(0) or (p == Shard(2) and k.placements[i] == Shard(2))
      else Replicate() for i, p in enumerate(qp))
  grad_kvp = tuple(Partial() if p == Shard(2) and kv == Replicate() else kv
                   for p, kv in zip(qp, kvp))
  q = _local.to_placements(q, qp)
  k = _local.to_placements(k, kvp)
  v = _local.to_placements(v, kvp)
  g = q.shape[2] // k.shape[2]
  qlo, qhi = _local.shard_range(q, 2)
  klo, khi = _local.shard_range(k, 2)
  need_lo, need_hi = qlo // g, (qhi - 1) // g + 1
  g_local = (qhi - qlo) // (need_hi - need_lo)
  if (need_lo < klo or need_hi > khi
      or any((h // g - need_lo) != (h - qlo) // g_local
             for h in range(qlo, qhi))):
    raise ValueError(f"flash_attention: query heads [{qlo}, {qhi}) of "
                     f"placements {q.placements} do not read a block of the "
                     f"kv heads [{klo}, {khi}) of placements {k.placements} "
                     f"at G = {g}")
  ql = q.to_local().contiguous()
  kl = k.to_local(grad_placements=grad_kvp)[:, :, need_lo - klo:
                                            need_hi - klo].contiguous()
  vl = v.to_local(grad_placements=grad_kvp)[:, :, need_lo - klo:
                                            need_hi - klo].contiguous()
  out = flash_attention(ql, kl, vl, **opts)
  b, sq, h, _ = q.shape
  shape = (b, sq, h, v.shape[-1])
  return DTensor.from_local(out, mesh, qp, shape=torch.Size(shape),
                            stride=torch.empty(shape, device="meta").stride())


# ---------------------------------------------------------------------------
# Backward: FlashAttention-2's algorithm in PyTorch ops.
# ---------------------------------------------------------------------------


def _scores(q_blk, k_blk, q0: int, k0: int, scale: float, causal: bool,
            window: int = 0, softcap: float = 0.0):
  """(masked f32 scores of a block (B, Hkv, G, cq, ckv), the soft-cap's
  derivative or None); q_blk (B, cq, Hkv, G, D) and k_blk (B, ckv, Hkv, D)
  in f32, starting at positions q0 (the query offset included), k0; with
  ``softcap`` c > 0 the scaled score s becomes c * tanh(s / c), whose
  derivative is 1 - (c * tanh(s / c) / c)^2; under a window (causal only)
  keys at or below query - window masked too, as in the forward."""
  s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk, k_blk) * scale
  dcap = None
  if softcap > 0.0:
    s = torch.tanh(s / softcap) * softcap
    dcap = 1.0 - torch.square(s / softcap)
  if causal:
    q_pos = torch.arange(q0, q0 + q_blk.shape[1], device=s.device)
    kv_pos = torch.arange(k0, k0 + k_blk.shape[1], device=s.device)
    masked = kv_pos[None, :] > q_pos[:, None]
    if window > 0:
      masked |= kv_pos[None, :] <= q_pos[:, None] - window
    s = s.masked_fill(masked, _NEG_INF)
  return s, dcap


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor,
                        causal: bool = True, *, window: int = 0,
                        softcap: float = 0.0, q_offset: int = 0,
                        q_chunk: int = 512, kv_chunk: int = 1024):
  """Gradients (dq, dk, dv) of attention at (q, k, v), output ``o`` and
  output cotangent ``do``, in the layouts and dtypes of q, k and v.

  FlashAttention-2's backward over query chunks of ``q_chunk`` rows and
  key chunks of ``kv_chunk`` (a ragged last chunk allowed; with ``causal``
  a key chunk wholly after a query chunk is skipped, and with a ``window``
  one wholly below every query's window; query i at position q_offset +
  i).  Per query chunk, first the row log-sum-exp of the masked scores S
  * scale (soft-capped where ``softcap`` > 0), merged chunk by chunk;
  then, per key chunk, P = exp(S * scale - lse), dV += P^T dO, dP = dO
  V^T, dS = P * (dP - D) with D = rowsum(dO * O), times the soft-cap's
  derivative, dQ += dS K * scale and dK += dS^T Q * scale, the G query
  heads of a kv head summed into its dK and dV.  Everything is f32 inside,
  on any device.
  """
  b, sq, h, d = q.shape
  _, skv, hkv, dv = v.shape
  g = h // hkv
  scale = 1.0 / math.sqrt(d)
  causal = causal or window > 0   # the plain version's window is causal
  f32 = torch.float32
  qf = q.to(f32).reshape(b, sq, hkv, g, d)
  kf, vf = k.to(f32), v.to(f32)
  dof = do.to(f32).reshape(b, sq, hkv, g, dv)
  delta = torch.einsum("bqhgc,bqhgc->bhgq", dof,
                       o.to(f32).reshape(b, sq, hkv, g, dv))
  dq, dk, dvv = (torch.zeros_like(x) for x in (qf, kf, vf))
  for q0 in range(0, sq, q_chunk):
    q1 = min(q0 + q_chunk, sq)
    p0, p1 = q0 + q_offset, q1 + q_offset       # the chunk's positions
    q_blk, do_blk = qf[:, q0:q1], dof[:, q0:q1]
    blocks = [(k0, min(k0 + kv_chunk, skv)) for k0 in range(0, skv, kv_chunk)
              if not causal or (k0 < p1 and (window <= 0 or min(
                  k0 + kv_chunk, skv) - 1 > p0 - window))]
    lse = None
    for k0, k1 in blocks:
      s, _ = _scores(q_blk, kf[:, k0:k1], p0, k0, scale, causal, window,
                     softcap)
      part = torch.logsumexp(s, dim=-1)
      lse = part if lse is None else torch.logaddexp(lse, part)
    d_blk = delta[..., q0:q1, None]
    for k0, k1 in blocks:
      k_blk, v_blk = kf[:, k0:k1], vf[:, k0:k1]
      s, dcap = _scores(q_blk, k_blk, p0, k0, scale, causal, window, softcap)
      p = torch.exp(s - lse[..., None])
      dvv[:, k0:k1] += torch.einsum("bhgqk,bqhgc->bkhc", p, do_blk)
      ds = p * (torch.einsum("bqhgc,bkhc->bhgqk", do_blk, v_blk) - d_blk)
      if dcap is not None:
        ds = ds * dcap
      dq[:, q0:q1] += torch.einsum("bhgqk,bkhd->bqhgd", ds, k_blk)
      dk[:, k0:k1] += torch.einsum("bhgqk,bqhgd->bkhd", ds, q_blk)
  return ((dq * scale).reshape(b, sq, h, d).to(q.dtype),
          (dk * scale).to(k.dtype), dvv.to(v.dtype))


# ---------------------------------------------------------------------------
# Error models of the kernel and of the backward.
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
                       v: torch.Tensor, causal: bool, window: int = 0,
                       softcap: float = 0.0,
                       q_offset: int = 0) -> dict[str, float]:
  """The kernel's output against the plain version in f32 on the same bf16
  inputs, with the same mask and scores (``window``, ``softcap`` and
  ``q_offset`` as in ``flash_attention``).

  The kernel rounds P to bf16 for the P V product and the output to bf16,
  each a relative error of at most BF16_U; its f32 scores, exponentials and
  sums (and its f32 tanh under a soft-cap, whose slope is at most 1) add
  errors near 1e-6.  So element (i, c) is off by at most
  BF16_U * (|ref_ic| + A_ic), with A = the same attention over |v| (the
  softmax-weighted mean of |v_jc|).  ``tol_ratio`` is the largest
  |out - ref| / (2 * BF16_U * (|ref| + A)), at most 1 for a right kernel;
  ``rel_frob`` is the relative Frobenius error, at most REL_FROB_LIMIT;
  ``median_ref`` is the median |ref|, the scale that both sit against.
  """
  qf, kf, vf = q.float(), k.float(), v.float()
  opts = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
  ref = flash_attention_plain(qf, kf, vf, **opts)
  a = flash_attention_plain(qf, kf, vf.abs(), **opts)
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


def _magnitudes(q, k, v, do, causal: bool, window: int = 0,
                softcap: float = 0.0, q_offset: int = 0):
  """The backward's terms over absolute values, in f32, dense: for each
  of dq, dk, dv the same sums as the gradient with every factor replaced
  by its size, D by A_D = rowsum(|dO| * (|O| + A)) (A the attention over
  |v|: the forward kernel's own error bound is 2 * BF16_U * (|O| + A)),
  and dS by its size times the soft-cap's derivative."""
  b, sq, h, d = q.shape
  hkv = k.shape[2]
  g = h // hkv
  qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
  kh, vh = (x.repeat_interleave(g, dim=2) for x in (kf, vf))
  s = torch.einsum("bqhd,bkhd->bhqk", qf, kh) / math.sqrt(d)
  dcap = 1.0
  if softcap > 0.0:
    s = torch.tanh(s / softcap) * softcap
    dcap = 1.0 - torch.square(s / softcap)
  if causal or window > 0:
    q_pos = q_offset + torch.arange(sq, device=s.device)[:, None]
    kv_pos = torch.arange(k.shape[1], device=s.device)[None, :]
    mask = kv_pos <= q_pos
    if window > 0:
      mask &= kv_pos > q_pos - window
    s = s.masked_fill(~mask, _NEG_INF)
  p = torch.softmax(s, dim=-1)
  o = torch.einsum("bhqk,bkhc->bqhc", p, vh).abs()
  a_fwd = torch.einsum("bhqk,bkhc->bqhc", p, vh.abs())
  a_d = torch.sum(dof.abs() * (o + a_fwd), dim=-1).transpose(1, 2)
  a_ds = p * (torch.einsum("bqhc,bkhc->bhqk", dof.abs(), vh.abs())
              + a_d[..., None]) * dcap
  scale = 1.0 / math.sqrt(d)
  a_dq = torch.einsum("bhqk,bkhd->bqhd", a_ds, kh.abs()) * scale
  a_dk = torch.einsum("bhqk,bqhd->bkhd", a_ds, qf.abs()) * scale
  a_dv = torch.einsum("bhqk,bqhc->bkhc", p, dof.abs())
  fold = lambda x: x.reshape(x.shape[:2] + (hkv, g, x.shape[-1])).sum(3)
  return a_dq, fold(a_dk), fold(a_dv)


def compare_bwd_with_plain(grads, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, do: torch.Tensor, causal: bool,
                           window: int = 0, softcap: float = 0.0,
                           q_offset: int = 0
                           ) -> dict[str, dict[str, float]]:
  """``grads`` = (dq, dk, dv) against the autograd of the plain version in
  f32 on the same inputs and options, by the error model of the forward
  carried through the backward.

  ``flash_attention_bwd`` computes in f32 from the kernel's bf16 output O,
  which is within 2 * BF16_U * (|O| + A) of the exact one; through
  D = rowsum(dO * O) that moves each gradient by at most 2 * BF16_U times
  its term over absolute values (``_magnitudes``: A_dq, A_dk, A_dv), and
  the cast of the result to bf16 adds BF16_U * |grad|.  So, as for the
  forward, element (i, c) of each gradient is held within 2 * BF16_U *
  (|ref_ic| + A_ic) (``tol_ratio`` at most 1) and the relative Frobenius
  error within REL_FROB_LIMIT.  Returns, by gradient name, the keys of
  ``compare_with_plain``.
  """
  xs = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
  ref = flash_attention_plain(*xs, causal=causal, window=window,
                              softcap=softcap, q_offset=q_offset)
  refs = torch.autograd.grad(ref, xs, do.float())
  out = {}
  for name, got, want, a in zip(("dq", "dk", "dv"), grads, refs,
                                _magnitudes(q, k, v, do, causal, window,
                                            softcap, q_offset)):
    err = (got.float() - want).abs()
    tol = torch.clamp(2 * BF16_U * (want.abs() + a), min=1e-30)
    out[name] = {
        "finite": bool(torch.isfinite(got).all()),
        "max_abs_err": float(err.max()),
        "tol_ratio": float((err / tol).max()),
        "rel_frob": float(torch.linalg.vector_norm(err)
                          / torch.linalg.vector_norm(want)),
        "median_ref": float(want.abs().median()),
    }
  return out
