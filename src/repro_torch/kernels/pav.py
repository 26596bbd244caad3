"""Batched Pool-Adjacent-Violators: the CUDA kernels and their plain version.

Counterpart of ``repro.kernels.pav``.  Over a (rows, n) batch:

* ``pav_l2`` / ``pav_kl``: wrappers around the two instantiations of the
  divide-and-conquer CUDA kernel in ``csrc/pav_scan.cu`` (log2(n) merge
  levels across threads; see the note there), whose plain versions are
  ``pav_scan.pav_l2_scan`` and ``pav_scan.pav_kl_scan``.
* Both take f32 CUDA tensors only and raise on any other device or dtype:
  the kernels solve in f32, and a silent f32 solve of an f64 input would
  return f64 with f32 precision (dispatch promotes halves to f32, and the
  built-in plan sends f64 on the card to ``scan``).  Each launch adds one
  to ``LAUNCHES[<kernel>]``; a batch of
  more than 65535 rows (the grid's limit) is launched in slices of 65535,
  one launch each.
* ``pav_l2_stack`` / ``pav_kl_stack``: the plain stack machine, a port of
  ``_pav_body`` that advances all rows together with masked pops, and of
  ``_expand`` as one vectorized gather (it only moves values), on any
  device, in the input's precision (f64 stays f64).  It is the ``"stack"``
  backend and the CPU default.

The stack machine merges a block into its left neighbour while the
neighbour's value is ``<=`` its own; the divide-and-conquer merge pools on
strict ``<`` in another order, so ``pav_l2`` / ``pav_kl`` agree with
``pav_l2_scan`` / ``pav_kl_scan`` on the card bit for bit (up to the
device's ``expf`` / ``log1pf`` for kl) and with the stack machine to the
last bits.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# Launch counts per kernel, read by chip_smoke.py to show that a run went
# through the kernels.  Only the wrappers below increment them.
LAUNCHES = {"pav_l2": 0, "pav_kl": 0}


def reset_launches() -> None:
  for name in LAUNCHES:
    LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Plain version: the batched stack machine.
# ---------------------------------------------------------------------------


def _pav_body(y_like: torch.Tensor, init_cur, merge, block_value):
  """Shared stack machine; the callbacks define the aggregate algebra:

    init_cur(i)        -> tuple of (R, 1) registers for the singleton block {i}
    merge(cur, popped) -> merged registers
    block_value(regs)  -> (R, 1) value of a block

  Returns (starts (R, N), values (R, N), top (R,)): slot k of a row holds
  its k-th block, for k <= top.  The stack arrays are updated in place, one
  slot per row and step.  Slot 0 of each stored array is a sentinel whose
  value is NaN: no comparison with NaN holds, so an empty stack never pops.
  Each block's value is stored when it is pushed, from the same registers
  the comparison would read, so every step reads one value per row.
  """
  r, n = y_like.shape
  device = y_like.device
  num_regs = len(init_cur(0))
  regs = tuple(torch.zeros((r, n + 1), dtype=y_like.dtype, device=device)
               for _ in range(num_regs))
  vals = torch.full((r, n + 1), float("nan"), dtype=y_like.dtype,
                    device=device)
  starts = torch.zeros((r, n + 1), dtype=torch.int64, device=device)
  positions = torch.arange(n, device=device).expand(r, n)
  top = torch.zeros((r, 1), dtype=torch.int64, device=device)

  for i in range(n):
    cur = init_cur(i)
    cur_val = block_value(cur)
    cur_start = positions[:, i:i + 1]
    while True:
      act = torch.gather(vals, 1, top) <= cur_val
      if not bool(act.any()):
        break
      top_regs = tuple(torch.gather(a, 1, top) for a in regs)
      merged = merge(cur, top_regs)
      cur = tuple(torch.where(act, m, c) for m, c in zip(merged, cur))
      cur_val = block_value(cur)
      cur_start = torch.where(act, torch.gather(starts, 1, top), cur_start)
      top = top - act.to(torch.int64)
    top = top + 1
    for a, v in zip(regs, cur):
      a.scatter_(1, top, v)
    vals.scatter_(1, top, cur_val)
    starts.scatter_(1, top, cur_start)
  return starts[:, 1:], vals[:, 1:], top[:, 0] - 1


def _expand(starts: torch.Tensor, vals: torch.Tensor, top: torch.Tensor,
            n: int) -> torch.Tensor:
  """Blocks -> positions: mark each live block's start, number the
  positions by a running count of the marks, and gather the block values.
  Moves values only, so the result is the pointer sweep's, bit for bit."""
  slot = torch.arange(starts.shape[1], device=starts.device)
  live = (slot <= top[:, None]).to(torch.int64)
  marks = torch.zeros((starts.shape[0], n), dtype=torch.int64,
                      device=starts.device)
  marks.scatter_add_(1, starts * live, live)
  return torch.gather(vals, 1, torch.cumsum(marks, dim=1) - 1)


def _solve_dtype(x: torch.Tensor) -> torch.dtype:
  # float64 keeps full precision; halves compute in f32.
  return torch.promote_types(x.dtype, torch.float32)


def pav_l2_stack(y: torch.Tensor) -> torch.Tensor:
  """Batched isotonic regression on (B, N) via the plain stack machine."""
  yc = y.to(_solve_dtype(y))
  if yc.numel() == 0:
    return y.clone()
  ones = torch.ones((yc.shape[0], 1), dtype=yc.dtype, device=yc.device)
  starts, vals, top = _pav_body(
      yc,
      init_cur=lambda i: (yc[:, i:i + 1], ones),
      merge=lambda cur, pop: (cur[0] + pop[0], cur[1] + pop[1]),
      block_value=lambda regs: regs[0] / torch.clamp(regs[1], min=1e-30),
  )
  return _expand(starts, vals, top, y.shape[-1]).to(y.dtype)


def pav_kl_stack(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
  """Batched entropic isotonic optimization on (B, N), plain stack machine."""
  dt = torch.promote_types(_solve_dtype(s), _solve_dtype(w))
  sc, wc = s.to(dt), w.to(dt)
  if sc.numel() == 0:
    return s.clone()
  starts, vals, top = _pav_body(
      sc,
      init_cur=lambda i: (sc[:, i:i + 1], wc[:, i:i + 1]),
      merge=lambda cur, pop: (torch.logaddexp(cur[0], pop[0]),
                              torch.logaddexp(cur[1], pop[1])),
      block_value=lambda regs: regs[0] - regs[1],
  )
  return _expand(starts, vals, top, s.shape[-1]).to(s.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels.
# ---------------------------------------------------------------------------

_PTR, _I64 = ctypes.c_void_p, ctypes.c_int64


def _check(name: str, *xs: torch.Tensor) -> None:
  x = xs[0]
  for t in xs:
    if t.device.type != "cuda":
      raise ValueError(f"{name} launches a CUDA kernel and takes CUDA "
                       f"tensors only; got a tensor on {t.device}")
    if t.dtype != torch.float32:
      raise TypeError(f"{name} solves in f32 and takes float32 tensors "
                      f"only; got {t.dtype} (f64 on the card: the scan "
                      "backend)")
    if t.dim() != 2 or t.shape != x.shape:
      raise ValueError(f"{name} takes (rows, n) tensors of one shape; got "
                       f"{[tuple(u.shape) for u in xs]}")
    if t.device != x.device:
      raise ValueError(f"{name}: tensors on {x.device} and {t.device}")
  if x.shape[1] >= 2**31:
    raise ValueError(f"{name}: n = {x.shape[1]} does not fit int32 starts")


# The kernels' grid takes at most this many rows (gridDim.y); a larger
# batch is launched in slices of it, one launch (and one count) a slice.
MAX_GRID_ROWS = 65535


def row_slices(rows: int) -> list[tuple[int, int]]:
  """[start, stop) row ranges of at most ``MAX_GRID_ROWS`` rows each."""
  return [(r, min(r + MAX_GRID_ROWS, rows))
          for r in range(0, rows, MAX_GRID_ROWS)]


def _launch_slices(kname: str, reg: str, ins: list[torch.Tensor],
                   out: torch.Tensor) -> None:
  """Launch the ``reg`` instantiation of ``csrc/pav_scan.cu`` on every row
  slice of the f32, contiguous ``ins`` into ``out``, sharing one work
  buffer sized for the largest slice (the launches queue on one stream)."""
  rows, n = out.shape
  if rows == 0 or n == 0:
    return
  slices = row_slices(rows)
  work_bytes = _build.entry("pav_scan", f"pav_scan_{reg}_work_bytes",
                            [_I64, _I64], _I64)(slices[0][1], n)
  work = torch.empty((work_bytes,), dtype=torch.uint8, device=out.device)
  launch = _build.entry("pav_scan", f"pav_scan_{reg}_launch",
                        [_PTR] * (len(ins) + 2) + [_I64, _I64, _PTR])
  stream = _build.current_stream(out.device)
  with _build.on_device(out.device):
    for lo, hi in slices:
      err = launch(*(x[lo:hi].data_ptr() for x in ins),
                   out[lo:hi].data_ptr(), work.data_ptr(), hi - lo, n,
                   stream)
      if err != 0:
        raise RuntimeError(f"{kname} kernel launch failed with CUDA error "
                           f"{err}")
      LAUNCHES[kname] += 1


def pav_l2(y: torch.Tensor) -> torch.Tensor:
  """Batched isotonic regression (non-increasing), CUDA (B, N) -> (B, N):
  the divide-and-conquer kernel of ``csrc/pav_scan.cu``."""
  _check("pav_l2", y)
  x = y.contiguous()
  out = torch.empty_like(x)
  _launch_slices("pav_l2", "l2", [x], out)
  return out


def pav_kl(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
  """Batched entropic isotonic optimization, CUDA (B, N) x (B, N) -> (B, N):
  the divide-and-conquer kernel of ``csrc/pav_scan.cu``, kl algebra."""
  _check("pav_kl", s, w)
  xs = [x.contiguous() for x in (s, w)]
  out = torch.empty_like(xs[0])
  _launch_slices("pav_kl", "kl", xs, out)
  return out
