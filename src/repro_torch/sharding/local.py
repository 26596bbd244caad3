"""Plain-tensor functions on the local blocks of DTensors.

The hand-written kernels launch through ctypes on raw pointers, and a
DTensor has no storage of its own; the isotonic solvers' stack machine and
divide and conquer read values to end their loops.  So where such a
function meets a DTensor it runs on each rank's local block, and the result
is wrapped back: ``keep_placements`` says which placements a function's
semantics allow (a row-wise function: shards of the leading dims), and
every other placement is redistributed explicitly first, so the
collective shows in a trace and in ``repro_torch.analysis.cost``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def keep_placements(x: DTensor, dims: Sequence[int]) -> tuple:
  """``x``'s placements with each ``Shard(d)`` for d in ``dims`` kept and
  everything else (other shards, ``Partial``) made ``Replicate``."""
  dims = {d % x.dim() for d in dims}
  return tuple(p if isinstance(p, Shard) and p.dim in dims else Replicate()
               for p in x.placements)


def to_placements(x: DTensor, placements: tuple) -> DTensor:
  """``x`` redistributed to ``placements`` (itself when it has them)."""
  if tuple(x.placements) == tuple(placements):
    return x
  return x.redistribute(x.device_mesh, placements)


def local_block(t: torch.Tensor, mesh, placements) -> torch.Tensor:
  """This rank's block of a plain tensor that every rank holds whole, as
  a DTensor of ``placements`` would lay it out (even blocks)."""
  for i, p in enumerate(placements):
    if isinstance(p, Shard):
      n = mesh.size(i)
      size = t.shape[p.dim] // n
      t = t.narrow(p.dim, mesh.get_coordinate()[i] * size, size)
  return t


def on_rows(fn: Callable[..., torch.Tensor], *args,
            row_dims: Sequence[int] | None = None, **kwargs) -> DTensor:
  """``fn(*local args, **kwargs)`` for a function that maps each row (the
  last dim) of its tensor arguments on its own to an output of the first
  DTensor argument's shape: the rows stay where that DTensor has them
  (shards of the leading dims, or of ``row_dims``), the last dim is made
  whole.  Other DTensor arguments are laid out alike; a plain tensor
  argument of the same rank (the same on every rank) is cut to the local
  rows, one of lower rank broadcasts as it is.  Differentiable."""
  i_ref = next(i for i, a in enumerate(args) if isinstance(a, DTensor))
  ref = args[i_ref]
  if row_dims is None:
    row_dims = range(ref.dim() - 1)
  want = keep_placements(ref, row_dims)
  mesh = ref.device_mesh

  def localize(a):
    if isinstance(a, DTensor):
      return to_placements(a, want).to_local()
    if isinstance(a, torch.Tensor) and a.dim() == ref.dim():
      return local_block(a, mesh, want)
    return a

  local_args = [localize(a) for a in args]
  local_ref = local_args[i_ref]
  out = fn(*local_args, **kwargs)
  if tuple(out.shape) != tuple(local_ref.shape):
    raise ValueError(f"{getattr(fn, '__name__', fn)} on local rows gave "
                     f"shape {tuple(out.shape)} for {tuple(local_ref.shape)}")
  return DTensor.from_local(out, mesh, want, shape=ref.shape,
                            stride=torch.empty(ref.shape,
                                               device="meta").stride())


def grad_in_place(x: torch.Tensor) -> torch.Tensor:
  """``x`` itself in forward; in backward its gradient is first laid out
  as ``x`` is, so that the op that made ``x`` (a reshape, whose backward
  reshape DTensor refuses over a split inner dim) takes it.  A plain
  tensor passes through."""
  if not isinstance(x, DTensor):
    return x
  return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                            shape=x.shape, stride=x.stride())


def elementwise(fn: Callable[[torch.Tensor], torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
  """``fn(x)`` for an elementwise ``fn`` that DTensor has no rule for
  (``F.logsigmoid``'s backward): on the local block of a DTensor, every
  shard kept (a ``Partial`` summed first); a plain tensor directly."""
  if not isinstance(x, DTensor):
    return fn(x)
  return on_rows(fn, x, row_dims=range(x.dim() + 1))


def wrap(local: torch.Tensor, mesh, placements) -> DTensor:
  """``local`` as this rank's block of a contiguous DTensor laid out by
  ``placements``, each split even (the global shape is the local one
  times the split counts)."""
  shape = list(local.shape)
  for i, p in enumerate(placements):
    if isinstance(p, Shard):
      shape[p.dim] *= mesh.size(i)
  stride = torch.empty(shape, device="meta").stride()
  return DTensor.from_local(local, mesh, placements,
                            shape=torch.Size(shape), stride=stride)


def shard_range(x: DTensor, dim: int) -> tuple[int, int]:
  """[lo, hi) of dimension ``dim`` that this rank's block of ``x`` holds
  (even blocks: a dim split over axes whose product does not divide it
  raises)."""
  mesh = x.device_mesh
  coord = mesh.get_coordinate()
  size, lo = x.shape[dim], 0
  for i, p in enumerate(x.placements):
    if isinstance(p, Shard) and p.dim == dim:
      n = mesh.size(i)
      if size % n:
        raise ValueError(f"dim {dim} of size {size} does not split evenly "
                         f"over mesh dim {i} of size {n}")
      size //= n
      lo += coord[i] * size
  return lo, lo + size


_ELLIPSIS_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"


def _expand_ellipsis(eq: str, ndims: Sequence[int]) -> tuple[list[str], str]:
  """Each operand's letters and the output's, with ``...`` spelled out in
  capitals (right-aligned, as broadcasting aligns them)."""
  lhs, out = eq.replace(" ", "").split("->")
  terms = lhs.split(",")
  ell = max((nd - (len(t) - 3) for t, nd in zip(terms, ndims) if "..." in t),
            default=0)
  fill = _ELLIPSIS_LETTERS[:ell]
  expanded = []
  for t, nd in zip(terms, ndims):
    if "..." in t:
      n = nd - (len(t) - 3)
      t = t.replace("...", fill[ell - n:])
    expanded.append(t)
  return expanded, out.replace("...", fill)


def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
  """``torch.einsum``, and, where an operand is a DTensor, the same
  einsum on each rank's blocks, placed by a rule DTensor's own
  propagation does not follow through einsum's reshapes.

  On each mesh dimension one index letter is split: the first operand's
  sharded letter, else the next's.  Every operand holding that letter is
  split on it (a replicated one is sliced locally, one split on another
  letter gathered first); every other operand is gathered (an FSDP weight
  whose data axes meet the activations' batch: FSDP's all-gather at use).
  The output is split on the letter where it keeps it and ``Partial``
  where the letter is summed out.  A ``Partial`` operand is summed first,
  a plain one taken as replicated.  Plain operands alone run
  ``torch.einsum`` itself.  Differentiable: an operand without the split
  letter gets a ``Partial`` gradient on that mesh dimension."""
  mesh = next((t.device_mesh for t in operands if isinstance(t, DTensor)),
              None)
  if mesh is None:
    return torch.einsum(eq, *operands)
  ops = [t if isinstance(t, DTensor) else
         DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim)
         for t in operands]
  terms, out_letters = _expand_ellipsis(eq, [t.dim() for t in ops])
  sizes = {}
  for t, letters in zip(ops, terms):
    sizes.update(zip(letters, t.shape))
  want = [[Replicate()] * mesh.ndim for _ in ops]
  grad = [[Replicate()] * mesh.ndim for _ in ops]
  out_pl = [Replicate()] * mesh.ndim
  for i in range(mesh.ndim):
    split = None
    for t, letters in zip(ops, terms):
      p = t.placements[i]
      if isinstance(p, Shard):
        split = letters[p.dim]
        break
    if split is None:
      continue
    for j, letters in enumerate(terms):
      if split in letters:
        want[j][i] = grad[j][i] = Shard(letters.index(split))
      else:
        grad[j][i] = Partial()
    out_pl[i] = (Shard(out_letters.index(split)) if split in out_letters
                 else Partial())
  locals_ = [to_placements(t, tuple(w)).to_local(grad_placements=g)
             for t, w, g in zip(ops, want, grad)]
  out = torch.einsum(eq, *locals_)
  shape = torch.Size(sizes[c] for c in out_letters)
  return DTensor.from_local(out, mesh, out_pl, shape=shape,
                            stride=torch.empty(shape, device="meta").stride())


def assign(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
  """``dst.copy_(src)`` in place; for a DTensor ``dst``, ``src`` first
  redistributed to ``dst``'s placements (an in-place op cannot move
  ``dst``)."""
  if isinstance(dst, DTensor) and isinstance(src, DTensor):
    src = to_placements(src, tuple(dst.placements))
  return dst.copy_(src)


def write_positions(cache: torch.Tensor, start: int,
                    value: torch.Tensor) -> None:
  """``cache[:, start:start + n] = value`` in place, ``value`` (B, n, ...)
  cast to the cache's dtype: the prefill's and decode's cache writes.  On
  a DTensor cache each rank writes the part of the positions its block
  holds (its sequence block where the cache splits the sequence), from
  ``value`` redistributed to the cache's placements with the sequence
  whole."""
  if not isinstance(cache, DTensor):
    cache[:, start:start + value.shape[1]] = value.to(cache.dtype)
    return
  want = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
               for p in cache.placements)
  if not isinstance(value, DTensor):
    value = DTensor.from_local(value, cache.device_mesh,
                               [Replicate()] * cache.device_mesh.ndim)
  value = to_placements(value, want).to_local()
  lo, hi = shard_range(cache, 1)
  a, b = max(start, lo), min(start + value.shape[1], hi)
  if a < b:
    cache.to_local()[:, a - lo:b - lo] = value[:, a - start:b - start].to(
        cache.dtype)
