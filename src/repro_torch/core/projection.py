"""Projections onto the permutahedron (paper §4-§5, Prop. 3).

  P_Psi(z, w) = z - v_Psi(z_sigma(z), sort_desc(w))_{sigma^{-1}(z)}

Counterpart of ``repro.core.projection``.  ``P(w)`` is permutation-invariant
in ``w``, so ``w`` need not be sorted by the caller.  Two registered
pipelines compute it (keys ``("projection", regularization, path)``,
selected by ``path=`` > ``REPRO_TORCH_PROJECTION`` > the execution plans,
which resolve to ``"fused"``):

``"fused"`` (default)
    One ``torch.autograd.Function`` around sort + isotonic solve + gather.
    When a gradient is wanted, the forward saves sigma, sigma^{-1},
    tau^{-1} and the solver's block starts (``segscan`` derives each
    position's block start/end indices from them in the backward); the
    backward is gather -> Lemma 2 segment algebra -> gather, with no
    re-sort.
    Without autograd (``no_grad``, ``inference_mode``) the forward saves
    nothing.  ``z_is_sorted`` / ``w_is_sorted`` skip sorts the caller
    guarantees, and ``z_perm`` / ``w_perm`` supply precomputed
    (sigma, sigma^{-1}) pairs, for example from a ``SortContext``.  An
    unbatched ``w`` on the CPU is sorted once per distinct vector (a small
    process cache keyed by its bytes, counters ``sort_reuse_hit`` /
    ``sort_reuse_miss``); on the card it is sorted on the device every
    call, since hashing its values would copy it to the host and
    synchronise.

``"composed"``
    The reference chain of differentiable primitives (descending sorts,
    isotonic solve, inverse-permutation scatter) whose backward autograd
    derives by composition; kept for differential testing of the fused
    path.

Both are batched-first: ``z`` may carry leading batch dimensions and there
is one isotonic dispatch per call.  An unbatched ``w`` (shape (n,)) is
sorted once and broadcast into the solver; its gradient is summed over the
batch.
"""

from __future__ import annotations

import functools
import hashlib
from collections import OrderedDict

import torch

from repro_torch.core.isotonic import isotonic_kl, isotonic_l2
from repro_torch.core.permutations import (
    apply_inverse_permutation,
    argsort_descending,
    inverse_permutation,
    sort_descending,
)
from repro_torch.kernels import dispatch as _dispatch
from repro_torch.kernels import segment_vjp as _svjp
from repro_torch.obs import metrics as _metrics

_REGS = ("l2", "kl")
_HALF_DTYPES = (torch.bfloat16, torch.float16)


# ---------------------------------------------------------------------------
# Composed reference pipeline.
# ---------------------------------------------------------------------------


def _composed_projection(regularization: str, z: torch.Tensor,
                         w: torch.Tensor, impl: str | None, plan=None, *,
                         z_is_sorted: bool = False, w_is_sorted: bool = False,
                         z_perm=None, w_perm=None) -> torch.Tensor:
  """z: (..., n); w: (n,) or broadcastable to z.shape.

  Ignores the sortedness hints on purpose and re-derives everything
  through composed differentiable primitives: that is what the fused
  path is tested against.
  """
  del z_is_sorted, w_is_sorted, z_perm, w_perm
  if w.dim() == 1:
    # Unbatched weights: one sort, shared across every row of the batch.
    w_sorted, _ = sort_descending(w)
  else:
    w_sorted, _ = sort_descending(w.expand(z.shape))
  s, sigma = sort_descending(z)
  if regularization == "l2":
    v = isotonic_l2(s - w_sorted, impl, plan)
  else:
    v = isotonic_kl(s, w_sorted, impl, plan)
  # out = z - v_{sigma^{-1}}, i.e. out[sigma_k] = z[sigma_k] - v[k].
  return z - apply_inverse_permutation(v, sigma)


# ---------------------------------------------------------------------------
# Sorted-weight cache for unbatched weights on the CPU.
# ---------------------------------------------------------------------------

_W_CACHE_CAP = 64
_w_sorted_cache: OrderedDict[tuple, tuple] = OrderedDict()


def _sorted_w_unbatched(ws: torch.Tensor):
  """(tau, tau^{-1}) of an unbatched CPU weight row, sorted once per
  distinct vector in a small bounded process cache: an eager eps sweep
  that re-projects onto the same permutahedron pays for one weight sort.
  The key is the row's bytes; CUDA rows never come here (their bytes are
  on the device)."""
  host = ws.detach().contiguous()
  key = (tuple(host.shape), str(host.dtype),
         hashlib.sha1(host.numpy().tobytes()).hexdigest())
  hit = key in _w_sorted_cache
  _metrics.counter_inc("sort_reuse_hit" if hit else "sort_reuse_miss",
                       source="w_cache")
  if hit:
    _w_sorted_cache.move_to_end(key)
  else:
    tau = argsort_descending(host)
    while len(_w_sorted_cache) >= _W_CACHE_CAP:
      _w_sorted_cache.popitem(last=False)
    _w_sorted_cache[key] = (tau, inverse_permutation(tau))
  return _w_sorted_cache[key]


# ---------------------------------------------------------------------------
# Fused pipeline: one autograd Function around sort + solve + gather.
# ---------------------------------------------------------------------------


def _unbroadcast(g: torch.Tensor, shape: torch.Size) -> torch.Tensor:
  """Sum a full-batch cotangent down to a broadcast-origin shape."""
  if g.shape == shape:
    return g
  extra = g.dim() - len(shape)
  if extra:
    g = g.sum(dim=tuple(range(extra)))
  dims = tuple(i for i, (a, b) in enumerate(zip(g.shape, shape))
               if b == 1 and a != 1)
  if dims:
    g = g.sum(dim=dims, keepdim=True)
  return g.reshape(shape)


def _gather(x: torch.Tensor, idx: torch.Tensor | None) -> torch.Tensor:
  return x if idx is None else torch.gather(x, -1, idx)


class _FusedProjection(torch.autograd.Function):

  @staticmethod
  def forward(ctx, z, w, regularization, impl, plan, z_is_sorted,
              w_is_sorted, z_perm, w_perm, save):
    n = z.shape[-1]
    if z_is_sorted:
      s, sigma, sigma_inv = z, None, None
    elif z_perm is not None:
      sigma, sigma_inv = z_perm
      s = torch.gather(z, -1, sigma)
    else:
      sigma = argsort_descending(z)
      s = torch.gather(z, -1, sigma)
      sigma_inv = inverse_permutation(sigma)

    ws = w
    if ws.dim() > 1 and ws.shape != z.shape:
      ws = ws.expand(z.shape)
    tau_inv = None
    if w_is_sorted:
      w_sorted = ws
    elif w_perm is not None:
      tau, tau_inv = w_perm
      w_sorted = torch.gather(ws, -1, tau)
    elif ws.dim() == 1 and ws.device.type == "cpu":
      tau, tau_inv = _sorted_w_unbatched(ws)
      w_sorted = torch.gather(ws, -1, tau)
    else:
      tau = argsort_descending(ws)
      w_sorted = torch.gather(ws, -1, tau)
      tau_inv = inverse_permutation(tau)

    if regularization == "l2":
      w_b = None
      v = _dispatch.dispatch("isotonic", "l2", impl, s - w_sorted, plan=plan)
    else:
      w_b = w_sorted.expand(s.shape)
      v = _dispatch.dispatch("isotonic", "kl", impl, s, w_b, plan=plan)
    out = z - _gather(v, sigma_inv)
    if not save:
      return out

    starts = _svjp.block_starts(v.reshape(-1, n))
    ctx.regularization = regularization
    ctx.plan = plan
    ctx.w_shape = w.shape
    ctx.save_for_backward(sigma, sigma_inv, tau_inv, starts,
                          s if regularization == "kl" else None, w_b)
    return out

  @staticmethod
  def backward(ctx, g):
    # The block structure is saved flat as (rows, n); dispatch_backward
    # flattens every argument the same way.
    sigma, sigma_inv, tau_inv, starts, s, w_b = ctx.saved_tensors

    # d out / d v is -I composed with the sigma^{-1} gather: permute the
    # cotangent into sorted order.
    g_v = -_gather(g, sigma)
    if ctx.regularization == "l2":
      g_y = _dispatch.dispatch_backward("projection", "l2", None, g_v,
                                        starts, plan=ctx.plan)
      g_s, g_ws = g_y, -g_y
    else:
      g_s, g_ws = _dispatch.dispatch_backward(
          "projection", "kl", None, s, w_b, g_v, starts, plan=ctx.plan)

    # z cotangent: identity term plus the solve term mapped back through
    # sigma^{-1} (a gather: sigma^{-1} is already a residual).
    g_z = g + _gather(g_s, sigma_inv)

    # w cotangent: back from sorted order via tau^{-1}, then un-broadcast
    # (sum) onto the original weight shape.
    if len(ctx.w_shape) == 1:
      g_w = _gather(_unbroadcast(g_ws, ctx.w_shape), tau_inv)
    else:
      g_w = _unbroadcast(_gather(g_ws, tau_inv), ctx.w_shape)
    return g_z, g_w, None, None, None, None, None, None, None, None


def _fused_projection(regularization: str, z: torch.Tensor, w: torch.Tensor,
                      impl: str | None, plan=None, *,
                      z_is_sorted: bool = False, w_is_sorted: bool = False,
                      z_perm=None, w_perm=None) -> torch.Tensor:
  save = torch.is_grad_enabled() and (z.requires_grad or w.requires_grad)
  return _FusedProjection.apply(z, w, regularization, impl, plan,
                                bool(z_is_sorted), bool(w_is_sorted), z_perm,
                                w_perm, save)


for _reg in _REGS:
  _dispatch.register("projection", _reg, "fused")(
      functools.partial(_fused_projection, _reg))
  _dispatch.register("projection", _reg, "composed")(
      functools.partial(_composed_projection, _reg))


# ---------------------------------------------------------------------------
# Public API.
# ---------------------------------------------------------------------------


def projection_permutahedron(
    z: torch.Tensor, w: torch.Tensor, regularization: str = "l2",
    impl: str | None = None, *, path: str | None = None, plan=None,
    z_is_sorted: bool = False, w_is_sorted: bool = False,
    z_perm=None, w_perm=None) -> torch.Tensor:
  """Project ``z`` onto the permutahedron generated by ``w`` (paper §4).

  Computes P_Psi(z, w) = z - v_Psi(z_sigma(z), sort_desc(w))_{sigma^{-1}}
  (Prop. 3): one descending sort, one isotonic solve, one un-permute.

  Parameters
  ----------
  z : Tensor, shape (..., n)
      Point(s) to project (last axis; arbitrary leading batch dims).
  w : Tensor, shape (n,) or broadcastable to z.shape
      Permutahedron generator; need not be sorted.  Cast to z's dtype and
      device.
  regularization : {"l2", "kl"}
      "l2": Euclidean projection onto P(w).  "kl": the paper's log-KL
      projection of e^z onto P(e^w), returned in log space (P_E).
  impl : {"auto", "cuda", "stack", "scan", "minimax"} or None
      Isotonic backend (``repro_torch.kernels.dispatch``).
  path : {"auto", "fused", "composed"} or None
      Pipeline; None defers to ``REPRO_TORCH_PROJECTION``, then the plans
      ("fused").
  plan : repro_torch.plan.ExecutionPlan or None
      Pin an execution plan for every decision of this call (forward
      backend, backward backend, projection path); the fused backward
      keeps it, so it also governs a backward run after a ``use_plan``
      scope has closed.
  z_is_sorted, w_is_sorted : bool
      Caller guarantees the argument is already descending along the last
      axis; the fused path skips that sort.
  z_perm, w_perm : (sigma, sigma^{-1}) int64 pairs or None
      Precomputed descending-argsort permutations of the argument.

  Returns
  -------
  Tensor, shape broadcast(z, w)
  """
  if regularization not in _REGS:
    raise ValueError(f"regularization must be one of {_REGS}")
  w = torch.as_tensor(w, dtype=z.dtype, device=z.device)
  if z.dtype in _HALF_DTYPES:
    # The whole pipeline runs promoted; only the result is demoted.
    out = _dispatch.dispatch_projection(
        z.float(), w.float(), regularization, impl, path, plan=plan,
        z_is_sorted=z_is_sorted, w_is_sorted=w_is_sorted, z_perm=z_perm,
        w_perm=w_perm)
    return out.to(z.dtype)
  return _dispatch.dispatch_projection(
      z, w, regularization, impl, path, plan=plan, z_is_sorted=z_is_sorted,
      w_is_sorted=w_is_sorted, z_perm=z_perm, w_perm=w_perm)
