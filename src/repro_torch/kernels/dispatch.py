"""Backend dispatch for the batched isotonic/projection stack.

Counterpart of ``repro.kernels.dispatch``.  One choke point through which
every soft-sort/rank pass routes: a *forward* registry mapping
``(op, regularization, backend)`` -> implementation, and a *backward*
registry mapping ``(op, regularization, backward_backend)`` -> VJP
implementation.  Implementations see ``(rows, n)`` tensors only: leading
batch axes are flattened here and restored on return.  bf16/f16 inputs are
promoted to f32 here, once, and the result is demoted back, for every
backend and both directions; no backend casts on its own.

Forward backends (``isotonic`` op)
----------------------------------
* ``"cuda"``     the hand-written CUDA kernels (``repro_torch.kernels.pav``
                 ``pav_l2`` / ``pav_kl``); CUDA tensors only, raises on any
                 other device.
* ``"stack"``    the plain PyTorch stack machine (``pav_l2_stack`` /
                 ``pav_kl_stack``), on any device; the counterpart of the
                 reference's ``"lax"``.
* ``"scan"``     the plain divide-and-conquer PAV
                 (``repro_torch.kernels.pav_scan``), on any device; the
                 reference's ``"scan"``, and the plain version of the
                 kernels.
* ``"minimax"``  the O(n^2) closed form (``repro_torch.kernels.ref``).

Backward backends: ``"scatter"`` (``repro_torch.kernels.segment_vjp``).

Selection: explicit argument (``impl=`` / ``path=``) > environment
(``REPRO_TORCH_BACKEND`` / ``REPRO_TORCH_PROJECTION``) > built-in choice;
``"auto"`` falls through.  The built-in choice picks ``"cuda"`` for a CUDA
tensor, always, and ``"stack"`` for a tensor on the CPU; the projection
path is ``"fused"``.  ``"minimax"`` is reached only when asked for.

This differs from the reference on purpose.  The reference's built-in plan
routes n <= 64 to minimax (``repro/plan/__init__.py``) and has execution
plans, a packaged default plan and metrics; the port has none of those
yet, and its built-in choice never routes main-path traffic away from the
kernel.  The port reads its own environment variables: the reference
validates ``REPRO_BACKEND`` and raises on names it does not know, so the
two packages never share one.
"""

from __future__ import annotations

import os
from typing import Callable

import torch

from repro_torch.obs import tracing as _tracing

ENV_VAR = "REPRO_TORCH_BACKEND"
PROJECTION_ENV_VAR = "REPRO_TORCH_PROJECTION"

BACKENDS = ("auto", "cuda", "stack", "scan", "minimax")
PROJECTION_PATHS = ("auto", "fused", "composed")

_REGISTRY: dict[tuple[str, str, str], Callable] = {}
_BWD_REGISTRY: dict[tuple[str, str, str], Callable] = {}


def register(op: str, regularization: str, backend: str):
  """Decorator: register ``fn`` as the (op, regularization, backend) impl."""

  def deco(fn: Callable) -> Callable:
    _REGISTRY[(op, regularization, backend)] = fn
    return fn

  return deco


def register_backward(op: str, regularization: str, backend: str):
  """Decorator: register a VJP impl under (op, regularization, backend)."""

  def deco(fn: Callable) -> Callable:
    _BWD_REGISTRY[(op, regularization, backend)] = fn
    return fn

  return deco


def registered_backends(op: str, regularization: str) -> tuple[str, ...]:
  """Concrete backends registered for an (op, regularization)."""
  return tuple(b for (o, r, b) in _REGISTRY
               if o == op and r == regularization)


def _env_choice(env_var: str, allowed: tuple[str, ...]) -> str | None:
  """Validated environment value, or None when unset or empty."""
  raw = os.environ.get(env_var)
  if not raw:
    return None
  if raw not in allowed:
    raise ValueError(f"{env_var}={raw!r} is not a known backend; "
                     f"expected one of {allowed}")
  return raw


def resolve(op: str, regularization: str, request: str | None,
            device: torch.device) -> str:
  """Forward backend: ``impl=`` > ``REPRO_TORCH_BACKEND`` > built-in."""
  if request and request != "auto":
    backend = request
  else:
    backend = _env_choice(ENV_VAR, BACKENDS)
    if not backend or backend == "auto":
      backend = "cuda" if device.type == "cuda" else "stack"
  if (op, regularization, backend) not in _REGISTRY:
    raise ValueError(
        f"no forward backend {backend!r} registered for op={op!r}, "
        f"regularization={regularization!r}; have "
        f"{registered_backends(op, regularization)}")
  return backend


def resolve_projection(path: str | None = None) -> str:
  """Projection path: ``path=`` > ``REPRO_TORCH_PROJECTION`` > fused."""
  if path and path != "auto":
    chosen = path
  else:
    chosen = _env_choice(PROJECTION_ENV_VAR, PROJECTION_PATHS)
    if not chosen or chosen == "auto":
      chosen = "fused"
  if chosen not in PROJECTION_PATHS:
    raise ValueError(f"projection path must be one of {PROJECTION_PATHS}, "
                     f"got {chosen!r}")
  return chosen


def _promote_flat(args: tuple[torch.Tensor, ...], n: int):
  """Flatten to (rows, n) and promote every floating argument below f32 to
  f32; integer and bool structure arrays pass through.  Returns the flat
  list and the floating dtype to demote results back to (None when no
  argument is floating)."""
  floating = [a.dtype for a in args if a.is_floating_point()]
  orig = None
  for dt in floating:
    orig = dt if orig is None else torch.promote_types(orig, dt)
  flat = []
  for a in args:
    f = a.reshape(-1, n)
    if a.is_floating_point():
      f = f.to(torch.promote_types(a.dtype, torch.float32))
    flat.append(f)
  return flat, orig


def _restore(out, shape, orig_dtype):
  if isinstance(out, tuple):
    return tuple(_restore(o, shape, orig_dtype) for o in out)
  if orig_dtype is not None:
    out = out.to(orig_dtype)
  return out.reshape(shape)


def dispatch(op: str, regularization: str, backend: str | None,
             *args: torch.Tensor) -> torch.Tensor:
  """Route a batched forward pass to the resolved backend.

  All ``args`` share one shape whose last axis is the problem dimension.
  The backend call runs under a ``repro_<op>_<reg>_<backend>`` profiler
  range.
  """
  shape = args[0].shape
  b = resolve(op, regularization, backend, args[0].device)
  flat, orig_dtype = _promote_flat(args, shape[-1])
  with _tracing.backend_scope(op, regularization, b):
    out = _REGISTRY[(op, regularization, b)](*flat)
  return _restore(out, shape, orig_dtype)


def dispatch_backward(op: str, regularization: str, backend: str | None,
                      *args: torch.Tensor):
  """Route a batched VJP to its backward backend (``"scatter"``).

  Same flattening and promote/demote contract as ``dispatch``; the impl
  may return one gradient or a tuple of them, each restored to the batch
  shape.  Runs under a ``repro_<op>_bwd_<reg>_<backend>`` range.
  """
  b = backend or "scatter"
  if (op, regularization, b) not in _BWD_REGISTRY:
    raise ValueError(f"no backward backend {b!r} for op={op!r}, "
                     f"regularization={regularization!r}")
  shape = args[0].shape
  flat, orig_dtype = _promote_flat(args, shape[-1])
  with _tracing.backend_scope(f"{op}_bwd", regularization, b):
    out = _BWD_REGISTRY[(op, regularization, b)](*flat)
  return _restore(out, shape, orig_dtype)


def dispatch_projection(z: torch.Tensor, w: torch.Tensor, regularization: str,
                        impl: str | None, path: str | None = None,
                        **kwargs) -> torch.Tensor:
  """Route a permutahedron projection to the fused or composed pipeline.

  Implementations own their batching (the fused path sorts an unbatched
  ``w`` once for the whole batch), so ``z`` and ``w`` pass unflattened;
  ``kwargs`` carry the sortedness hints and precomputed permutations.
  """
  p = resolve_projection(path)
  fn = _REGISTRY.get(("projection", regularization, p))
  if fn is None:
    raise ValueError(
        f"no projection path {p!r} registered for "
        f"regularization={regularization!r} (import "
        f"repro_torch.core.projection)")
  with _tracing.backend_scope("projection", regularization, p):
    return fn(z, w, impl, **kwargs)


# ---------------------------------------------------------------------------
# Backend registration (isotonic optimization, paper §5).
# ---------------------------------------------------------------------------

from repro_torch.kernels import pav as _pav  # noqa: E402
from repro_torch.kernels import pav_scan as _pav_scan  # noqa: E402
from repro_torch.kernels import ref as _ref  # noqa: E402
from repro_torch.kernels import segment_vjp as _svjp  # noqa: E402

register("isotonic", "l2", "cuda")(_pav.pav_l2)
register("isotonic", "kl", "cuda")(_pav.pav_kl)

register("isotonic", "l2", "stack")(_pav.pav_l2_stack)
register("isotonic", "kl", "stack")(_pav.pav_kl_stack)

register("isotonic", "l2", "scan")(_pav_scan.pav_l2_scan)
register("isotonic", "kl", "scan")(_pav_scan.pav_kl_scan)

register("isotonic", "l2", "minimax")(_ref.pav_l2_ref)
register("isotonic", "kl", "minimax")(_ref.pav_kl_ref)

register_backward("isotonic", "l2", "scatter")(_svjp.isotonic_l2_bwd_scatter)
register_backward("isotonic", "kl", "scatter")(_svjp.isotonic_kl_bwd_scatter)

# Forward projection paths ("fused" / "composed") register themselves on
# ``repro_torch.core.projection`` import: kernels must not import core.
register_backward("projection", "l2",
                  "scatter")(_svjp.projection_l2_bwd_scatter)
register_backward("projection", "kl",
                  "scatter")(_svjp.projection_kl_bwd_scatter)
