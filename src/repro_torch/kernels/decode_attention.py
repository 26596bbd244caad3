"""Decode attention: the split-KV CUDA kernel and its plain version.

One query position a sequence, q (B, H, D), against the caches k and v
(B, S, Hkv, D) of positions [lo, lo + S) (lo > 0 only for a block of a
cache sharded over positions), of which those below ``cache_len`` and,
with ``window`` > 0, at or above ``cache_len - window`` are valid.  Query
head h reads kv head h // G (G = H / Hkv); scores in f32, scale 1 /
sqrt(D), with ``softcap`` c > 0 c * tanh(s / c) before the mask.  Both
versions return (o (B, H, D) in q's dtype, the f32 log-sum-exp of each
row's masked scores (B, H)); a block with no valid position gives o = 0
and lse = -inf, so that blocks combine by their lse with weights
exp(lse_i - lse).

The reference has no kernel here (its decode attention is plain ops).

* ``decode_block``: a CUDA tensor runs ``csrc/decode_attention.cu`` (see
  the note there) under the plan ``split_plan`` picks on the host, over
  the valid positions alone (``valid_range``), reading the caches where
  they lie; a CPU tensor the plain version; any other device raises.  A
  CUDA call outside the kernel's dtypes (f32, bf16) or widths (D = Dv, a
  multiple of 8 up to 256) raises before the launch.  Each launch adds one
  to ``LAUNCHES["decode_attention"]``.
* ``decode_block_plain``: the masked softmax over the whole block in plain
  PyTorch ops (the reference's arithmetic: scores in f32 from products in
  the inputs' dtype, the weights cast to the values' dtype).
* ``compare_with_plain``: the kernel's error model against the plain
  version in f32 on the same inputs.
"""

from __future__ import annotations

import ctypes
import functools
import math
import types

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as _fa
from repro_torch.sharding.local import einsum

# Launch count of the kernel; only the launch op below increments it.
LAUNCHES = {"decode_attention": 0}
# csrc/decode_attention.cu's constants: parts (warps) a block, positions a
# tile, the widest D, shared memory a block may take, query heads a row
# group by dtype.
WARPS = 4
TILE_KEYS = 16
MAX_WIDTH = 256
SMEM_LIMIT = 232_448
ROWS = {torch.bfloat16: 16, torch.float32: 8}
# The plan's aim: about this many warps (parts x row groups x kv heads x
# batch), ~4 waves of 8 resident warps on each of the H100's 132 SMs, and
# at least this many tiles a part.
TARGET_WARPS = 32 * 132
MIN_PART_TILES = 4
MAX_STAGES = 3

_NEG_INF = -1e30


def reset_launches() -> None:
  LAUNCHES["decode_attention"] = 0


def valid_range(lo: int, s: int, cache_len: int,
                window: int = 0) -> tuple[int, int]:
  """(start, length): the valid positions of a block of ``s`` positions
  from ``lo`` are its local positions [start, start + length); length 0
  (and start 0) where none is valid."""
  first = max(cache_len - window, 0) if window > 0 else 0
  a = max(first, lo) - lo
  e = min(cache_len, lo + s) - lo
  if e <= a:
    return 0, 0
  return a, e - a


def smem_bytes(dtype: torch.dtype, d: int, stages: int) -> int:
  """Shared bytes of a block (the kernel's ``smem_bytes`` counts the same;
  the launch refuses a plan whose count differs): the row group's Q rows,
  each warp's ring of ``stages`` K and V tiles of ``TILE_KEYS`` rows and,
  f32, each warp's P tile.  Rows are padded: bf16 to round16(D) + 8
  elements, f32 to D + 4."""
  if dtype == torch.bfloat16:
    stride = -(-d // 16) * 16 + 8
    return 2 * (ROWS[dtype] * stride + WARPS * stages * 2 * TILE_KEYS * stride)
  stride = d + 4
  return 4 * (ROWS[dtype] * stride
              + WARPS * (stages * 2 * TILE_KEYS * stride
                         + TILE_KEYS * ROWS[dtype]))


@functools.lru_cache(maxsize=4096)
def split_plan(dtype: torch.dtype, b: int, h: int, hkv: int, d: int,
               length: int) -> dict:
  """The launch plan, a pure function of the shapes and the valid length.

  ``row_groups`` = ceil(G / rows) (rows 16 for bf16, 8 for f32); the valid
  positions cut into ``parts`` runs of ``part_keys`` (a multiple of
  ``TILE_KEYS``, at least ``MIN_PART_TILES`` tiles), as many as bring the
  warps near ``TARGET_WARPS``; one empty part where nothing is valid.
  ``stages``: the deepest ring up to ``MAX_STAGES`` whose shared bytes fit.
  ``grid``: (blocks of ``WARPS`` parts, Hkv x row groups, B).  Cached, so
  read-only."""
  rows = ROWS[dtype]
  row_groups = -(-(h // hkv) // rows)
  units = max(b * hkv * row_groups, 1)
  tiles = -(-length // TILE_KEYS)
  want = max(1, -(-TARGET_WARPS // units))
  part_tiles = max(MIN_PART_TILES, -(-tiles // want))
  parts = max(1, -(-tiles // part_tiles))
  stages = next(s for s in range(MAX_STAGES, 0, -1)
                if smem_bytes(dtype, d, s) <= SMEM_LIMIT)
  return types.MappingProxyType({
      "rows": rows, "row_groups": row_groups,
      "part_keys": part_tiles * TILE_KEYS, "parts": parts, "stages": stages,
      "smem": smem_bytes(dtype, d, stages),
      "grid": (-(-parts // WARPS), hkv * row_groups, b)})


def decode_block_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lo: int, cache_len: int, window: int = 0,
                       softcap: float = 0.0):
  """Plain version: the masked softmax over the block's ``S`` positions
  (masks at the global positions lo ..), (o, lse) as in the module's
  docstring."""
  b, h, d = q.shape
  s, hkv = k.shape[1:3]
  if valid_range(lo, s, cache_len, window)[1] == 0:
    return (q.new_zeros((b, h, v.shape[-1])),
            torch.full((b, h), -math.inf, device=q.device))
  qg = q.reshape(b, hkv, h // hkv, d)
  scores = einsum("bhgd,bkhd->bhgk", qg, k).to(torch.float32)
  scores = scores * (1.0 / math.sqrt(d))
  if softcap > 0.0:
    scores = torch.tanh(scores / softcap) * softcap
  pos = torch.arange(lo, lo + s, device=q.device)
  valid = pos < cache_len
  if window > 0:
    valid &= pos > cache_len - 1 - window
  scores = torch.where(valid, scores,
                       torch.full((), _NEG_INF, device=q.device))
  p = torch.softmax(scores, dim=-1)
  o = einsum("bhgk,bkhd->bhgd", p.to(v.dtype), v)
  return (o.reshape(b, h, v.shape[-1]),
          torch.logsumexp(scores, dim=-1).reshape(b, h))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
  """The kernel's inputs: one CUDA device, one dtype, f32 or bf16; q (B,
  H, D), k and v (B, S, Hkv, D) with D = Dv a multiple of 8 up to
  ``MAX_WIDTH``, Hkv dividing H; the caches' last dim contiguous, every
  stride and pointer 16-byte aligned.  What the layouts decide is checked
  once a layout (``_CHECKED``), the pointers on every call."""
  key = (q.shape, q.dtype, q.device, k.shape, k.stride(), k.dtype, k.device,
         v.shape, v.stride(), v.dtype, v.device)
  if key not in _CHECKED:
    _check_layout(q, k, v)
    if len(_CHECKED) > 4096:
      _CHECKED.clear()
    _CHECKED.add(key)
  for name, t in (("q", q), ("k", k), ("v", v)):
    if t.data_ptr() % 16:
      raise ValueError(f"decode_attention takes 16-byte aligned tensors; "
                       f"{name} is not")


# The layouts ``_check_layout`` has passed.
_CHECKED: set = set()


def _check_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
  for name, t in (("k", k), ("v", v)):
    if t.dtype != q.dtype:
      raise TypeError(f"decode_attention: q is {q.dtype}, {name} is "
                      f"{t.dtype}")
    if t.device != q.device:
      raise ValueError(f"decode_attention: q on {q.device}, {name} on "
                       f"{t.device}")
  if q.dtype not in ROWS:
    raise TypeError(f"the decode_attention kernel takes f32 or bf16; q is "
                    f"{q.dtype}")
  if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
    raise ValueError(f"decode_attention takes q (B, H, D) and caches (B, S, "
                     f"Hkv, D); got {tuple(q.shape)}, {tuple(k.shape)}, "
                     f"{tuple(v.shape)}")
  b, h, d = q.shape
  if k.shape[0] != b or k.shape[-1] != d or v.shape != k.shape:
    raise ValueError(f"decode_attention: shapes q {tuple(q.shape)}, k "
                     f"{tuple(k.shape)}, v {tuple(v.shape)} do not match "
                     "(B, H, D), (B, S, Hkv, D), (B, S, Hkv, D)")
  hkv = k.shape[2]
  if hkv == 0 or h % hkv:
    raise ValueError(f"decode_attention: H = {h} must be a multiple G of "
                     f"Hkv = {hkv}")
  if d % 8 or not 8 <= d <= MAX_WIDTH:
    raise ValueError(f"decode_attention: D = {d} must be a multiple of 8 up "
                     f"to {MAX_WIDTH}")
  per = 16 // q.element_size()
  for name, t in (("k", k), ("v", v)):
    if t.stride(-1) != 1 or any(x % per for x in t.stride()[:3]):
      raise ValueError(f"decode_attention: {name}'s last dim must be "
                       f"contiguous and its strides multiples of {per}; got "
                       f"{t.stride()}")


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=())
def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, start: int,
            length: int, softcap: float) -> tuple[torch.Tensor, torch.Tensor]:
  """One launch of the kernel (its split pass and its combine) over the
  cache positions [start, start + length), on tensors its check passes.
  Its fake implementation gives the shapes of o and lse."""
  if q.device.type != "cuda":
    raise ValueError(f"the decode_attention kernel runs on CUDA tensors; got "
                     f"{q.device}")
  q = q.contiguous()
  _check(q, k, v)
  b, h, d = q.shape
  hkv = k.shape[2]
  plan = split_plan(q.dtype, b, h, hkv, d, length)
  out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
  lse = torch.empty((b, h), dtype=torch.float32, device=q.device)
  # The parts' scratch, one buffer: O (b, h, parts, d), then m and l (b, h,
  # parts) each.
  rows = b * h * plan["parts"]
  scratch = torch.empty((rows * (d + 2),), dtype=torch.float32,
                        device=q.device)
  base = scratch.data_ptr()
  launch = _build.entry(
      "decode_attention", "decode_attention_launch",
      [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 6
      + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [ctypes.c_void_p])
  with _build.on_device(q.device):
    err = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), base, base + 4 * rows * d, base + 4 * rows * (d + 1),
        int(q.dtype == torch.bfloat16), b, h,
        hkv, d,
        *k.stride()[:3], *v.stride()[:3], int(start), int(length),
        plan["part_keys"], plan["parts"], plan["stages"], plan["smem"],
        1.0 / math.sqrt(d), float(softcap), _build.current_stream(q.device))
  if err != 0:
    raise RuntimeError(f"decode_attention kernel launch failed with CUDA "
                       f"error {err}")
  LAUNCHES["decode_attention"] += 1
  return out, lse


@_launch.register_fake
def _(q, k, v, start, length, softcap):
  return (q.new_empty(q.shape[:2] + (v.shape[-1],)),
          q.new_empty(q.shape[:2], dtype=torch.float32))


def decode_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lo: int,
                 cache_len: int, window: int = 0, softcap: float = 0.0):
  """(o, lse) of q against the block of positions [lo, lo + S): the kernel
  over the valid positions on a CUDA tensor, the plain version on a CPU
  tensor; any other device raises."""
  if q.device.type == "cpu":
    return decode_block_plain(q, k, v, lo, cache_len, window, softcap)
  if q.device.type != "cuda":
    raise ValueError(f"decode_attention takes CPU or CUDA tensors; got "
                     f"{q.device}")
  start, length = valid_range(lo, k.shape[1], cache_len, window)
  return _launch(q, k, v, start, length, max(float(softcap), 0.0))


def decode_bytes(q: torch.Tensor, k: torch.Tensor, lo: int, cache_len: int,
                 window: int = 0) -> int:
  """The bytes a call must move: the valid K and V rows once, q in, o and
  the f32 lse out (the bound of the kernel's time at 3.35 TB/s)."""
  b, h, d = q.shape
  length = valid_range(lo, k.shape[1], cache_len, window)[1]
  return (2 * b * length * k.shape[2] * d + 2 * b * h * d) * k.element_size() \
      + 4 * b * h


def compare_with_plain(o: torch.Tensor, lse: torch.Tensor, q: torch.Tensor,
                       k: torch.Tensor, v: torch.Tensor, lo: int,
                       cache_len: int, window: int = 0,
                       softcap: float = 0.0) -> dict[str, float]:
  """The kernel's (o, lse) against the plain version in f32 on the same
  inputs; the model follows o's dtype (``flash_attention``'s constants).

  bf16 o: the kernel's scores are f32 sums of exact products; it rounds P
  to bf16 for the P V product and o to bf16, each a relative error of at
  most BF16_U, and its f32 softmax, the parts' combine and the soft-cap
  add errors near 1e-6.  So element (h, c) is off by at most BF16_U
  (|ref| + A), A the same attention over |v|; ``tol_ratio`` is the largest
  |o - ref| / (2 BF16_U (|ref| + A)), at most 1; ``rel_frob`` at most
  REL_FROB_LIMIT.

  f32 o: both round every step in f32 (u = F32_U).  With sigma the row's
  largest scale * sum_d |q_d k_d| over its n valid keys, t = n // 16 + 2 +
  parts (the tiles and parts at which the running max rescales), the
  model of ``flash_attention.compare_with_plain``: |o - ref| <= 2 u
  (((2 D + 12 + 2 t) sigma + 2 n + 3 t + 3) A + |ref|), ``rel_frob`` at
  most F32_REL_FROB_LIMIT.

  lse, both dtypes: the scores' error (2 D + 12 + 2 t) u sigma (bf16
  products are exact in f32, and the tensor cores' f32 sums are held to the
  same count) and the sum's and logarithm's, (2 n + 3 t + 3) u, so
  |lse - ref| <= 2 u ((2 D + 12 + 2 t) sigma + 2 n + 3 t + 3 + |ref|);
  ``lse_ratio`` at most 1.  A row with no valid key must give o = 0 and
  lse = -inf (``empty_ok``).
  """
  qf, kf, vf = q.float(), k.float(), v.float()
  ref, ref_lse = decode_block_plain(qf, kf, vf, lo, cache_len, window,
                                    softcap)
  a, _ = decode_block_plain(qf, kf, vf.abs(), lo, cache_len, window, softcap)
  b, h, d = q.shape
  s, hkv = k.shape[1:3]
  start, n = valid_range(lo, s, cache_len, window)
  if n == 0:
    empty_ok = bool((o == 0).all()) and bool(torch.isneginf(lse).all())
    return {"finite": True, "max_abs_err": 0.0, "tol_ratio": 0.0,
            "lse_ratio": 0.0, "rel_frob": 0.0, "rel_frob_limit": 0.0,
            "empty_ok": empty_ok, "median_ref": 0.0}
  kv = kf[:, start:start + n].abs().repeat_interleave(h // hkv, dim=2)
  sigma = torch.einsum("bhd,bkhd->bhk", qf.abs(), kv).amax(-1) / math.sqrt(d)
  parts = split_plan(q.dtype, b, h, hkv, d, n)["parts"]
  t = n // TILE_KEYS + 2 + parts
  kappa = (2 * d + 12 + 2 * t) * sigma + 2 * n + 3 * t + 3
  err = (o.float() - ref).abs()
  if o.dtype == torch.float32:
    tol = 2 * _fa.F32_U * (kappa[..., None] * a + ref.abs())
    limit = _fa.F32_REL_FROB_LIMIT
  else:
    tol = 2 * _fa.BF16_U * (ref.abs() + a)
    limit = _fa.REL_FROB_LIMIT
  tol = torch.clamp(tol, min=1e-30)
  lse_tol = 2 * _fa.F32_U * (kappa + ref_lse.abs())
  return {
      "finite": bool(torch.isfinite(o).all() and torch.isfinite(lse).all()),
      "max_abs_err": float(err.max()),
      "tol_ratio": float((err / tol).max()),
      "lse_ratio": float(((lse - ref_lse).abs() / lse_tol).max()),
      "rel_frob": float(torch.linalg.vector_norm(err)
                        / torch.linalg.vector_norm(ref)),
      "rel_frob_limit": limit,
      "empty_ok": True,
      "median_ref": float(ref.abs().median()),
  }
