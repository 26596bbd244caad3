"""Isotonic optimization via Pool-Adjacent-Violators (paper §5).

Counterpart of ``repro.core.isotonic``.  Solves, along the last axis,

  v_Q(s, w) = argmin_{v_1 >= ... >= v_n} 1/2 ||v - (s - w)||^2            (Q)
  v_E(s, w) = argmin_{v_1 >= ... >= v_n} <e^{s-v}, 1> + <e^w, v>          (E)

exactly, with one dispatch call per forward pass
(``repro_torch.kernels.dispatch``): the CUDA kernel for a CUDA tensor, the
plain stack machine on the CPU, or the backend named by ``impl``.

The backward pass is exact and O(n) (Lemma 2): the Jacobian is
block-diagonal with rank-1 blocks, recovered from runs of equal values in
the forward output, so the VJP is a couple of batched segment reductions
(``dispatch_backward``) and never differentiates through solver iterates.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import dispatch as _d


class _IsotonicL2(torch.autograd.Function):

  @staticmethod
  def forward(ctx, y, impl, plan):
    v = _d.dispatch("isotonic", "l2", impl, y, plan=plan)
    ctx.plan = plan
    ctx.save_for_backward(v)
    return v

  @staticmethod
  def backward(ctx, g):
    # Lemma 2 (Q): dv/dy is block-diagonal with blocks 11^T/|B| (symmetric).
    (v,) = ctx.saved_tensors
    return (_d.dispatch_backward("isotonic", "l2", None, v, g,
                                 plan=ctx.plan), None, None)


class _IsotonicKL(torch.autograd.Function):

  @staticmethod
  def forward(ctx, s, w, impl, plan):
    w_b = w.expand(s.shape)
    v = _d.dispatch("isotonic", "kl", impl, s, w_b, plan=plan)
    ctx.plan = plan
    ctx.save_for_backward(s, w, v)
    return v

  @staticmethod
  def backward(ctx, g):
    s, w, v = ctx.saved_tensors
    # Lemma 2 (E): B_j = 1 (x) softmax(s_B); transpose-multiply:
    #   grad_s = softmax(s_B) * sum(g_B);  grad_w = -softmax(w_B) * sum(g_B).
    grad_s, grad_w = _d.dispatch_backward("isotonic", "kl", None, s,
                                          w.expand(s.shape), v, g,
                                          plan=ctx.plan)
    # Un-broadcast the w gradient if w was unbatched.
    if w.shape != s.shape:
      grad_w = grad_w.reshape((-1,) + tuple(w.shape)).sum(0)
    return grad_s, grad_w, None, None


def isotonic_l2(y: torch.Tensor, impl: str | None = None,
                plan=None) -> torch.Tensor:
  """Isotonic regression: argmin ||v - y||^2, v non-increasing (last axis).
  ``plan`` pins an execution plan for the forward and the backward."""
  return _IsotonicL2.apply(y, impl, plan)


def isotonic_kl(s: torch.Tensor, w: torch.Tensor, impl: str | None = None,
                plan=None) -> torch.Tensor:
  """Entropic-regularization isotonic optimization (paper Eq. 8), last axis.

  ``w`` may be unbatched (shape (n,)); its gradient is summed over the
  batch.  ``plan`` pins an execution plan for the forward and the backward.
  """
  return _IsotonicKL.apply(s, w, impl, plan)


# ---------------------------------------------------------------------------
# Backend selection: thin aliases over the dispatch shims.
# ---------------------------------------------------------------------------


def set_default_impl(impl: str) -> None:
  """Set the process-wide forward backend (one of ``dispatch.BACKENDS``;
  ``"auto"`` goes back to the plans)."""
  _d.set_default_backend(impl)


@contextlib.contextmanager
def use_impl(impl: str):
  """Select the isotonic solver backend for the scope of a ``with``."""
  with _d.use_backend(impl):
    yield
