"""Flash attention: two CUDA forward kernels, the backward, plain versions.

Counterpart of ``repro.kernels.flash_attention`` (the TPU kernel) and of
the chunked attention in ``repro.models.layers.flash_attention``, in the
JAX layout: q (B, Sq, H, D), k (B, Skv, Hkv, D), v (B, Skv, Hkv, Dv),
output (B, Sq, H, Dv), with H = G * Hkv (GQA) and scale 1 / sqrt(D).

* ``flash_attention``: the one entry point the models call.  On a CUDA
  tensor, a ``torch.autograd.Function`` whose forward is one of two
  hand-written kernels, chosen by ``route`` from (dtype, D, Dv) alone,
  and whose backward is ``flash_attention_bwd``: bf16 at a width in
  ``KERNEL_WIDTHS`` runs ``csrc/flash_attention.cu`` (TMA + wgmma, f32
  softmax state; see the note there); f32, or bf16 at another multiple of
  8 up to ``SIMT_MAX_WIDTH``, runs ``csrc/flash_attention_simt.cu`` under
  the launch plan ``simt_plan`` picks on the host: f32 on the CUDA cores,
  register-tiled FFMA with no TF32 (bound by FFMA issue and the shared
  loads that feed it), bf16 on the tensor cores with mma.sync (bound by
  bytes, or by the tensor cores for long rows); anything else raises
  before a launch.
  Both take every option of the reference: the causal mask's sliding
  window (``window``, the ``local`` layers' attention; a window is causal
  whatever ``causal`` says), the logit soft-cap (``softcap``) and the
  query offset (``q_offset``).  On a CPU tensor, the plain version with
  every option, differentiated by autograd.  Each launch adds one to its
  kernel's count, ``LAUNCHES["flash_attention"]`` or
  ``LAUNCHES["flash_attention_simt"]``.
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
  the forward kernels (bf16 and f32 outputs) and of the backward, held
  against the plain version (and its autograd) in f32 on the same inputs,
  options and all.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import _build
from repro_torch.obs.tracing import span
from repro_torch.sharding import local as _local

# Launch count of each kernel; only the launch op below increments them.
LAUNCHES = {"flash_attention": 0, "flash_attention_simt": 0}
# The devices whose tensors go to the kernel's launch op.  A caller that
# traces on fake CPU tensors adds "cpu", so that the trace holds the launch
# as the card runs it (the op's fake implementation gives its shape).
KERNEL_DEVICES = {"cuda"}
# (D, Dv) built: the MLA widths (deepseek), the dense GQA head widths of
# llama3.2-1b and tinyllama-1.1b (64), of grok-1 (128), of gemma3-12b and
# recurrentgemma-2b (256) and of stablelm-3b (80, run padded to 128 inside
# the kernel): the tensor-core kernel's, for bf16.
KERNEL_WIDTHS = ((192, 128), (64, 64), (128, 128), (256, 256), (80, 80))
# The CUDA-core kernel takes f32 and bf16 at every D and Dv that are
# multiples of 8 up to this.
SIMT_MAX_WIDTH = 256
# Query rows of one block's tile: a work item takes 128 // G query positions
# of G heads each (at G = 6, 21 positions, 126 rows), so G is at most 128.
ROWS_PER_BLOCK = 128
# The CUDA-core kernel's launch plan (``simt_plan``): keys a K/V tile, the
# shared memory a block may take on the H100 (227 KB), the SM count whose
# blocks the row block is cut to fill, and its row blocks by path, the
# largest first (see ``simt_row_blocks``).
SIMT_KEYS = 64
SIMT_SMEM_LIMIT = 232_448
SIMT_SMS = 132
SIMT_ROWS = {"ffma": (64, 32, 16), "mma": (128, 64, 32, 16)}

_NEG_INF = -1e30


def reset_launches() -> None:
  for name in LAUNCHES:
    LAUNCHES[name] = 0


def route(dtype: torch.dtype, d: int, dv: int) -> str:
  """The kernel a CUDA call runs, by one static rule: ``"wgmma"``
  (``csrc/flash_attention.cu``) for bf16 at a width in ``KERNEL_WIDTHS``;
  ``"simt"`` (``csrc/flash_attention_simt.cu``) for f32, or bf16 at any
  other (D, Dv) of multiples of 8 up to ``SIMT_MAX_WIDTH``; any other
  dtype or width raises ``ValueError``."""
  if dtype == torch.bfloat16 and (d, dv) in KERNEL_WIDTHS:
    return "wgmma"
  if dtype in (torch.float32, torch.bfloat16) and all(
      x % 8 == 0 and 8 <= x <= SIMT_MAX_WIDTH for x in (d, dv)):
    return "simt"
  raise ValueError(
      f"flash_attention on the card takes f32 or bf16 with D and Dv "
      f"multiples of 8 up to {SIMT_MAX_WIDTH}; got {dtype} at (D, Dv) = "
      f"{(d, dv)}")


def simt_smem_bytes(path: str, rows: int, stages: int, d: int,
                    dv: int) -> int:
  """Shared bytes of a block of ``csrc/flash_attention_simt.cu`` (its
  ``smem_bytes`` counts the same; the launch refuses a plan whose count
  differs).  ffma, f32: Q rows padded to D + 4 floats, ``stages`` K tiles
  (D + 4) and V tiles (Dv) of ``SIMT_KEYS`` keys, P (rows x 68).  mma,
  bf16: Q and K rows of D rounded up to 16, plus 8 (so an ldmatrix's 8 rows
  fall in distinct banks), V rows of Dv, plus 8 where Dv / 8 is even; the
  block's 4 warps are rows / (16 MT) row groups (MT = 2 m16 tiles a warp
  at 128 rows, else 1) x 64 MT / rows key splits, so a stage holds one
  64-key tile a split, and the splits' merge (each lane's O fragments,
  Dv / 8 rounded up to even n8 tiles, m and l in f32) reuses the ring or,
  where larger, extends it; 16 bytes more for the last V read of an odd
  Dv / 8."""
  if path == "mma":
    qk = -(-d // 16) * 16 + 8
    vs = dv if (dv // 8) % 2 else dv + 8
    mt = 2 if rows == 128 else 1
    splits = SIMT_KEYS * mt // rows
    ring = stages * SIMT_KEYS * splits * (qk + vs)
    o_tiles = (dv // 8 + 1) // 2 * 2
    merge = (2 * rows // (16 * mt) * (splits - 1) * 32 * mt
             * (4 * o_tiles + 4))
    return 2 * (rows * qk + max(ring, merge)) + 16
  return 4 * (rows * (d + 4) + stages * SIMT_KEYS * (d + 4 + dv)
              + rows * (SIMT_KEYS + 4))


def simt_row_blocks(path: str, dv: int) -> tuple[int, ...]:
  """The row blocks a path takes at width Dv, the largest first: the
  largest of each (ffma 64 rows: 8 a thread; mma 128: two m16 tiles a
  warp) only where Dv <= 128, for the O registers."""
  rows = SIMT_ROWS[path]
  return rows if dv <= 128 else rows[1:]


def simt_plan(dtype: torch.dtype, b: int, sq: int, h: int, hkv: int, d: int,
              dv: int) -> dict:
  """The launch plan of ``csrc/flash_attention_simt.cu`` for q (b, sq, h,
  d) over hkv kv heads of width (d, dv): ``path`` ("ffma" for f32, "mma"
  for bf16), ``rows`` (query rows a block: (position, group) pairs),
  ``keys`` (a K/V tile), ``stages`` (tiles in flight: 2 where they fit in
  ``SIMT_SMEM_LIMIT``, else 1), ``smem`` (shared bytes) and ``blocks``.
  The row block is the largest of ``simt_row_blocks`` that fits and still
  gives at least ``SIMT_SMS`` blocks, else the smallest that fits, so that
  small grids spread over the card (bf16 blocks of 32 and 16 rows split
  the keys between their warps).  Raises ``ValueError`` where ``route``
  would not pick the kernel."""
  if route(dtype, d, dv) != "simt":
    raise ValueError(f"simt_plan: {dtype} at (D, Dv) = {(d, dv)} runs the "
                     "tensor-core kernel")
  path = "mma" if dtype == torch.bfloat16 else "ffma"
  fits = []
  for rows in simt_row_blocks(path, dv):
    stages = next((s for s in (2, 1) if simt_smem_bytes(
        path, rows, s, d, dv) <= SIMT_SMEM_LIMIT), None)
    if stages is not None:
      fits.append((rows, stages))
  pairs = b * hkv
  g = h // hkv
  def blocks(rows):
    return -(-sq * g // rows) * pairs
  rows, stages = next(((r, s) for r, s in fits if blocks(r) >= SIMT_SMS),
                      fits[-1])
  return {"path": path, "rows": rows, "keys": SIMT_KEYS, "stages": stages,
          "smem": simt_smem_bytes(path, rows, stages, d, dv),
          "blocks": blocks(rows)}


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


def _chunk_of(s: int, chunk: int) -> int:
  """The plain version's chunk over ``s`` positions: the largest divisor
  of ``s`` at most ``chunk``."""
  chunk = min(chunk, s)
  while s % chunk:
    chunk -= 1
  return chunk


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
  q_chunk, kv_chunk = _chunk_of(sq, q_chunk), _chunk_of(skv, kv_chunk)
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


def _check_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 0, q_offset: int = 0) -> None:
  """What both kernels need: one device, 4-D contiguous tensors of
  matching shapes, keys, and a key for every query."""
  for name, t in (("q", q), ("k", k), ("v", v)):
    if t.device != q.device:
      raise ValueError(f"flash_attention: q on {q.device}, {name} on "
                       f"{t.device}")
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
  if hkv == 0 or h % hkv:
    raise ValueError(f"flash_attention: H = {h} must be a multiple G of "
                     f"Hkv = {hkv}")
  if skv == 0:
    raise ValueError("flash_attention: no keys (Skv = 0)")
  if q_offset < 0:
    raise ValueError(f"flash_attention: q_offset = {q_offset} < 0 leaves "
                     "queries without a key under the causal mask")
  if window > 0 and q_offset + sq - window >= skv:
    raise ValueError(f"flash_attention: under a window of {window} the last "
                     f"query (position {q_offset + sq - 1}) sees none of the "
                     f"{skv} keys")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           window: int = 0, q_offset: int = 0) -> None:
  """The tensor-core kernel's inputs: bf16, a width in ``KERNEL_WIDTHS``,
  G at most ``ROWS_PER_BLOCK``."""
  for name, t in (("q", q), ("k", k), ("v", v)):
    if t.dtype != torch.bfloat16:
      raise TypeError(f"the flash_attention kernel takes bf16; {name} is "
                      f"{t.dtype}")
  _check_layout(q, k, v, window=window, q_offset=q_offset)
  h, hkv = q.shape[2], k.shape[2]
  d, dv = q.shape[3], v.shape[3]
  if h // hkv > ROWS_PER_BLOCK:
    raise ValueError(f"flash_attention: H = {h} must be a multiple G of "
                     f"Hkv = {hkv}, with G at most {ROWS_PER_BLOCK}")
  if (d, dv) not in KERNEL_WIDTHS:
    raise ValueError(f"flash_attention: (D, Dv) = {(d, dv)} is not built; "
                     f"the kernel has {KERNEL_WIDTHS}")


def _check_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                window: int = 0, q_offset: int = 0) -> None:
  """The CUDA-core kernel's inputs: one dtype, f32 or bf16, D and Dv
  multiples of 8 up to ``SIMT_MAX_WIDTH``, any G."""
  for name, t in (("k", k), ("v", v)):
    if t.dtype != q.dtype:
      raise TypeError(f"flash_attention: q is {q.dtype}, {name} is "
                      f"{t.dtype}")
  if q.dtype not in (torch.float32, torch.bfloat16):
    raise TypeError(f"the flash_attention_simt kernel takes f32 or bf16; "
                    f"q is {q.dtype}")
  _check_layout(q, k, v, window=window, q_offset=q_offset)
  d, dv = q.shape[3], v.shape[3]
  if not all(x % 8 == 0 and 8 <= x <= SIMT_MAX_WIDTH for x in (d, dv)):
    raise ValueError(f"flash_attention_simt: (D, Dv) = {(d, dv)} must be "
                     f"multiples of 8 up to {SIMT_MAX_WIDTH}")


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: int, softcap: float,
            q_offset: int) -> torch.Tensor:
  """One launch of the forward kernel that ``route`` picks (``window`` > 0
  with ``causal`` only, 0: none; ``softcap`` 0: none; the CUDA-core
  kernel under ``simt_plan``'s plan) on 16-byte aligned CUDA tensors that
  its check passes.  Its fake implementation gives the output's shape,
  with no check: a trace holds the launch at any width, whichever kernel
  runs it."""
  if q.device.type != "cuda":
    raise ValueError(f"the flash_attention kernel runs on CUDA tensors; got "
                     f"{q.device}")
  b, sq, h, d = q.shape
  _, skv, hkv, dv = v.shape
  plan_args = []
  if route(q.dtype, d, dv) == "wgmma":
    _check(q, k, v, window=window, q_offset=q_offset)
    name, dtype_arg = "flash_attention", []
  else:
    _check_simt(q, k, v, window=window, q_offset=q_offset)
    name, dtype_arg = "flash_attention_simt", [int(q.dtype == torch.bfloat16)]
    plan = simt_plan(q.dtype, b, sq, h, hkv, d, dv)
    plan_args = [plan["rows"], plan["keys"], plan["stages"], plan["smem"]]
  for t_name, t in (("q", q), ("k", k), ("v", v)):
    if t.data_ptr() % 16:
      raise ValueError(f"flash_attention takes 16-byte aligned tensors; "
                       f"{t_name} is not")
  # Each kernel is csrc/<name>.cu with the entry point <name>_launch.
  launch = _build.entry(
      name, f"{name}_launch",
      [ctypes.c_void_p] * 4 + [ctypes.c_int] * (10 + len(dtype_arg))
      + [ctypes.c_float] * 2 + [ctypes.c_int] * len(plan_args)
      + [ctypes.c_void_p])
  out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
  with _build.on_device(q.device):
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *dtype_arg,
        b, sq, skv, h, hkv, d, dv, int(causal), int(window), int(q_offset),
        1.0 / math.sqrt(d), float(softcap), *plan_args,
        _build.current_stream(q.device))
  if err != 0:
    raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
  LAUNCHES[name] += 1
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

  A CUDA tensor runs the kernel ``route`` picks (the tensor-core kernel
  for bf16 at a built width, the CUDA-core kernel for f32 or another
  width; ``q_chunk`` and ``kv_chunk`` are the plain version's chunking and
  do not apply; a ``window`` is causal, as in the plain version; every
  query must see a key), differentiable through ``flash_attention_bwd``;
  a CPU tensor the plain version; any other device raises.
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
  on any device.  Runs in the span ``repro_attention_bwd``, on the thread
  that launches its kernels.
  """
  with span("repro_attention_bwd"):
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
      blocks = [(k0, min(k0 + kv_chunk, skv))
                for k0 in range(0, skv, kv_chunk)
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
        s, dcap = _scores(q_blk, k_blk, p0, k0, scale, causal, window,
                          softcap)
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


# Unit roundoff of f32 (24 significant bits).
F32_U = 2.0**-24
# Limit on ||kernel - plain||_F / ||plain||_F for an f32 output: both
# round independently near a few units of 2**-24 times the scores' size
# (1e-6 to 1e-5 at the widths and scores the models give); a mask one key
# off or a mis-scaled tile moves the output by about 1 / (keys seen),
# far above it.
F32_REL_FROB_LIMIT = 2.0**-14


def _row_terms(q, k, causal: bool, window: int, softcap: float,
               q_offset: int):
  """Per query row, in the output's layout (B, Sq, H, 1): sigma, the
  largest scale * sum_d |q_d k_d| over the keys (an upper bound on every
  score's size and on its dot product's condition), and n, the keys the
  row sees."""
  b, sq, h, d = q.shape
  skv, hkv = k.shape[1], k.shape[2]
  kh = k.float().abs().repeat_interleave(h // hkv, dim=2)
  sigma = torch.einsum("bqhd,bkhd->bqhk", q.float().abs(), kh).amax(-1)
  sigma = sigma[..., None] / math.sqrt(d)
  pos = q_offset + torch.arange(sq, device=q.device, dtype=torch.float32)
  if causal or window > 0:
    hi = torch.clamp(pos + 1, max=skv)
    lo = torch.clamp(pos + 1 - window, min=0) if window > 0 else 0.0
    n = hi - lo
  else:
    n = torch.full_like(pos, float(skv))
  return sigma, n[None, :, None, None]


def _f32_tiles(n: torch.Tensor, skv: int) -> torch.Tensor:
  """t = n // c + 2: the most key tiles or chunks a row seeing n keys
  spans, and so the most times its running max rescales, c the shorter of
  the CUDA-core kernel's tiles (``SIMT_KEYS``) and the plain version's
  key chunk over ``skv`` (which can be shorter where 1024 does not divide
  Skv)."""
  return torch.floor(n / min(SIMT_KEYS, _chunk_of(skv, 1024))) + 2


def compare_with_plain(out: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, causal: bool, window: int = 0,
                       softcap: float = 0.0,
                       q_offset: int = 0) -> dict[str, float]:
  """A kernel's output against the plain version in f32 on the same inputs,
  with the same mask and scores (``window``, ``softcap`` and ``q_offset``
  as in ``flash_attention``); the model follows the output's dtype.

  bf16 output (either kernel on bf16 inputs): the tensor-core kernel
  rounds P to bf16 for the P V product and the output to bf16, each a
  relative error of at most BF16_U, and the CUDA-core kernel only the
  output; the f32 scores, exponentials and sums (and the f32 tanh under a
  soft-cap, whose slope is at most 1) add errors near 1e-6.  So element
  (i, c) is off by at most BF16_U * (|ref_ic| + A_ic), with A = the same
  attention over |v| (the softmax-weighted mean of |v_jc|).
  ``tol_ratio`` is the largest |out - ref| / (2 * BF16_U * (|ref| + A)),
  at most 1 for a right kernel; ``rel_frob`` the relative Frobenius
  error, at most REL_FROB_LIMIT.

  f32 output (the CUDA-core kernel on f32 inputs, FFMA throughout): the
  kernel and the plain version each round every step in f32 (u =
  F32_U), so each is within E of the exact result and they differ by at
  most 2 E.  For row i seeing n_i keys in t_i = n_i // c + 2 tiles or
  chunks at most (``_f32_tiles``: c the shorter of the kernel's tiles,
  ``SIMT_KEYS`` = 64 keys, and the plain version's key chunk over Skv),
  with sigma_i the largest scale * sum_d |q_id k_jd|:
    * a score is a dot product of D terms, then scaled: off by at most
      (D + 1) u sigma_i; the soft-cap's division, tanh (2 ulp) and
      product add at most 4 u sigma_i, its slope at most 1: e_s =
      (D + 5) u sigma_i;
    * a normalized weight exp(s_ij - lse_i) moves relatively by the two
      scores' errors, 2 e_s, and the rounding of s - m (at most 2 u
      sigma_i) and of exp (2 u), at most once a tile as the running max
      rescales (t_i (2 u sigma_i + 3 u)), the sum of its n_i positive
      terms (n_i u) and the division (u);
    * the output's n_i products and sums add n_i u of A_ic, and its
      rounding u |ref_ic|.
  So E_ic <= u ((2 D + 12 + 2 t_i) sigma_i + 2 n_i + 3 t_i + 3) A_ic +
  u |ref_ic|, and ``tol_ratio`` is the largest |out - ref| / (2 E), at
  most 1; ``rel_frob`` is held to F32_REL_FROB_LIMIT.  The bound is a
  worst case: the measured errors sit two to three orders of magnitude
  below it, and a key masked wrongly (about |v| / n_i) far above it.
  ``median_ref`` is the median |ref|, the scale that both sit against.
  """
  qf, kf, vf = q.float(), k.float(), v.float()
  opts = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
  ref = flash_attention_plain(qf, kf, vf, **opts)
  a = flash_attention_plain(qf, kf, vf.abs(), **opts)
  err = (out.float() - ref).abs()
  if out.dtype == torch.float32:
    sigma, n = _row_terms(q, k, causal, window, softcap, q_offset)
    t = _f32_tiles(n, k.shape[1])
    tol = 2 * F32_U * (((2 * q.shape[-1] + 12 + 2 * t) * sigma + 2 * n
                        + 3 * t + 3) * a + ref.abs())
    limit = F32_REL_FROB_LIMIT
  else:
    tol = 2 * BF16_U * (ref.abs() + a)
    limit = REL_FROB_LIMIT
  tol = torch.clamp(tol, min=1e-30)
  return {
      "finite": bool(torch.isfinite(out).all()),
      "max_abs_err": float(err.max()),
      "tol_ratio": float((err / tol).max()),
      "rel_frob": float(torch.linalg.vector_norm(err)
                        / torch.linalg.vector_norm(ref)),
      "rel_frob_limit": limit,
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

  bf16 gradients: ``flash_attention_bwd`` computes in f32 from the
  kernel's bf16 output O, which is within 2 * BF16_U * (|O| + A) of the
  exact one; through D = rowsum(dO * O) that moves each gradient by at
  most 2 * BF16_U times its term over absolute values (``_magnitudes``:
  A_dq, A_dk, A_dv), and the cast of the result to bf16 adds BF16_U *
  |grad|.  So, as for the forward, element (i, c) of each gradient is held
  within 2 * BF16_U * (|ref_ic| + A_ic) (``tol_ratio`` at most 1) and the
  relative Frobenius error within REL_FROB_LIMIT.

  f32 gradients (the CUDA-core kernel's f32 output): both the backward and
  the plain version's autograd round every step in f32 (u = F32_U), so,
  as for the f32 forward, they differ by at most 2 E with E_ic <= u
  (kappa A_ic + |ref_ic|).  A term of a gradient is a product with a
  normalized weight P_ij, whose relative error is the forward's, (2 D +
  12 + 2 t) sigma + n + 3 t + 3 units of u (t = ``_f32_tiles``: every
  chunk of the plain version, every tile of the kernel's forward that gave
  O); dP_ij sums Dv products (Dv u), D_i's error from O and its own sum is
  in A_D (``_magnitudes``); dS = P (dP - D), the scale, and the sum of the
  terms: n_i of them for dq's row i, up to G * Sq (every query row and
  head of the group) for an element of dk or dv.  So kappa = (2 D + 12 +
  2 t_i) sigma_i + 2 n_i + 3 t_i + Dv + 6 for dq, row by row, and for dk
  and dv the same at the largest sigma, n and t, with G * Sq in place of
  one n; the relative Frobenius error is held to F32_REL_FROB_LIMIT.  A
  key masked wrongly moves a row's terms by about 1 / n_i, far above
  this, and within the bf16 model at large n.

  Returns, by gradient name, the keys of ``compare_with_plain``.
  """
  xs = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
  ref = flash_attention_plain(*xs, causal=causal, window=window,
                              softcap=softcap, q_offset=q_offset)
  refs = torch.autograd.grad(ref, xs, do.float())
  f32 = grads[0].dtype == torch.float32
  if f32:
    sigma, n = _row_terms(q, k, causal, window, softcap, q_offset)
    t = _f32_tiles(n, k.shape[1])
    d, dv, g = q.shape[-1], v.shape[-1], q.shape[2] // k.shape[2]
    kappa_dq = (2 * d + 12 + 2 * t) * sigma + 2 * n + 3 * t + dv + 6
    s_max, n_max, t_max = (float(x.max()) for x in (sigma, n, t))
    kappa_kv = ((2 * d + 12 + 2 * t_max) * s_max + n_max + g * q.shape[1]
                + 3 * t_max + dv + 6)
    kappas = (kappa_dq, kappa_kv, kappa_kv)
  out = {}
  for i, (name, got, want, a) in enumerate(zip(
      ("dq", "dk", "dv"), grads, refs,
      _magnitudes(q, k, v, do, causal, window, softcap, q_offset))):
    err = (got.float() - want).abs()
    if f32:
      tol = 2 * F32_U * (kappas[i] * a + want.abs())
    else:
      tol = 2 * BF16_U * (want.abs() + a)
    tol = torch.clamp(tol, min=1e-30)
    out[name] = {
        "finite": bool(torch.isfinite(got).all()),
        "max_abs_err": float(err.max()),
        "tol_ratio": float((err / tol).max()),
        "rel_frob": float(torch.linalg.vector_norm(err)
                          / torch.linalg.vector_norm(want)),
        "rel_frob_limit": F32_REL_FROB_LIMIT if f32 else REL_FROB_LIMIT,
        "median_ref": float(want.abs().median()),
    }
  return out
