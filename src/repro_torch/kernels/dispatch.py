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
                 ``pav_l2`` / ``pav_kl``); f32 CUDA tensors only, raises on
                 any other device or dtype.
* ``"stack"``    the plain PyTorch stack machine (``pav_l2_stack`` /
                 ``pav_kl_stack``), on any device; the counterpart of the
                 reference's ``"lax"``.
* ``"scan"``     the plain divide-and-conquer PAV
                 (``repro_torch.kernels.pav_scan``), on any device; the
                 reference's ``"scan"``, and the plain version of the
                 kernels.
* ``"minimax"``  the O(n^2) closed form (``repro_torch.kernels.ref``).

Backward backends: ``"segscan"`` and ``"scatter"``
(``repro_torch.kernels.segment_vjp``).

Selection: one precedence chain for the three decision kinds (forward
backend, backward backend, projection path)::

    explicit argument (``impl=`` / ``backend=`` / ``path=``)
      > environment (REPRO_TORCH_BACKEND / REPRO_TORCH_BACKWARD /
        REPRO_TORCH_PROJECTION)
      > execution plan (per-call ``plan=``, else the active plan)
      > packaged default plan (none ships yet)
      > built-in plan (``repro_torch.plan.builtin_plan``: f64 on the card
        -> scan, the card -> cuda, otherwise stack; scatter on the card,
        segscan otherwise; fused)

``"auto"`` as an argument or environment value falls through to the
plans.  A plan rule matches on the tensor's device type (``platform``),
its dtype and its shape.  The port reads its own environment variables:
the reference validates ``REPRO_BACKEND`` and raises on names it does not
know, so the two packages never share one.

The reference resolves once per trace; the port resolves on every eager
call.  So the plan walk is memoized per (kind, op, regularization,
platform, dtype, shape, per-call plan); the memo is dropped whenever the
active or the default plan changes.  Every resolution records
``dispatch_resolve`` / ``dispatch_bwd_resolve`` / ``projection_resolve``
``{op,regularization,backend,source}`` and, when a plan decided,
``plan_decide{kind,backend,source,plan}`` (``repro_torch.obs.metrics``):
counts of calls, not of traces.
"""

from __future__ import annotations

import os
from typing import Callable

import torch

from repro_torch import plan as _plan
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import tracing as _tracing

ExecutionPlan = _plan.ExecutionPlan

ENV_VAR = "REPRO_TORCH_BACKEND"
BWD_ENV_VAR = "REPRO_TORCH_BACKWARD"
PROJECTION_ENV_VAR = "REPRO_TORCH_PROJECTION"

BACKENDS = ("auto", "cuda", "stack", "scan", "minimax")
BWD_BACKENDS = ("auto", "segscan", "scatter")
PROJECTION_PATHS = ("auto", "fused", "composed")

# One spec per decision kind: env var, allowed request values, and the
# counter each resolution records under.
_KIND_SPECS = {
    "forward": (ENV_VAR, BACKENDS, "dispatch_resolve"),
    "backward": (BWD_ENV_VAR, BWD_BACKENDS, "dispatch_bwd_resolve"),
    "projection": (PROJECTION_ENV_VAR, PROJECTION_PATHS,
                   "projection_resolve"),
}

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


def registered_backward_backends(op: str,
                                 regularization: str) -> tuple[str, ...]:
  """Concrete backward backends registered for an (op, regularization)."""
  return tuple(b for (o, r, b) in _BWD_REGISTRY
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


def dtype_name(dtype: torch.dtype) -> str:
  """A dtype as plans spell it: ``torch.float32`` -> ``"float32"``."""
  return str(dtype).removeprefix("torch.")


# Memo of plan decisions: query -> (backend, counter keys).  Bounded, and
# dropped when a plan changes.
MEMO_CAP = 4096
_MEMO: dict[tuple, tuple[str, str, str]] = {}
_plan.on_plan_change(_MEMO.clear)


def _decide(kind: str, op: str, regularization: str, platform: str,
            dtype: str, shape, plan) -> str:
  """The plan chain's backend for one query, memoized; records the
  resolution and ``plan_decide`` counters."""
  key = (kind, op, regularization, platform, dtype, shape, plan)
  hit = _MEMO.get(key)
  if hit is None:
    backend, source, _, name = _plan.decide(
        kind, op, regularization, platform=platform, dtype=dtype,
        shape=shape, plan=plan)
    counter = _KIND_SPECS[kind][2]
    hit = (backend,
           _metrics.key(counter, op=op, regularization=regularization,
                        backend=backend, source=source),
           _metrics.key("plan_decide", kind=kind, backend=backend,
                        source=source, plan=name))
    if len(_MEMO) >= MEMO_CAP:
      _MEMO.clear()
    _MEMO[key] = hit
  _metrics.bump(hit[1])
  _metrics.bump(hit[2])
  return hit[0]


def _resolve(kind: str, op: str, regularization: str, request: str | None,
             platform: str, dtype: str, shape, plan) -> str:
  """THE precedence chain: request > environment > plans."""
  env_var, allowed, counter = _KIND_SPECS[kind]
  if request and request != "auto":
    source = "arg"
    backend = request
  else:
    backend = _env_choice(env_var, allowed)
    source = "env"
    if not backend or backend == "auto":
      return _decide(kind, op, regularization, platform, dtype, shape, plan)
  _metrics.counter_inc(counter, op=op, regularization=regularization,
                       backend=backend, source=source)
  return backend


def resolve(op: str, regularization: str, request: str | None = None,
            device: torch.device | None = None, *, dtype: str = "*",
            shape=None, plan: ExecutionPlan | None = None) -> str:
  """Forward backend for a tensor on ``device`` (its type is the plans'
  platform): ``impl=`` > ``REPRO_TORCH_BACKEND`` > plans."""
  platform = "cpu" if device is None else torch.device(device).type
  backend = _resolve("forward", op, regularization, request, platform,
                     dtype, shape, plan)
  if (op, regularization, backend) not in _REGISTRY:
    raise ValueError(
        f"no forward backend {backend!r} registered for op={op!r}, "
        f"regularization={regularization!r}; have "
        f"{registered_backends(op, regularization)}")
  return backend


def resolve_backward(op: str, regularization: str,
                     request: str | None = None,
                     device: torch.device | None = None, *,
                     dtype: str = "*", shape=None,
                     plan: ExecutionPlan | None = None) -> str:
  """Backward backend: ``backend=`` > ``REPRO_TORCH_BACKWARD`` > plans."""
  platform = "cpu" if device is None else torch.device(device).type
  backend = _resolve("backward", op, regularization, request, platform,
                     dtype, shape, plan)
  if (op, regularization, backend) not in _BWD_REGISTRY:
    raise ValueError(
        f"no backward backend {backend!r} registered for op={op!r}, "
        f"regularization={regularization!r}; have "
        f"{registered_backward_backends(op, regularization)}")
  return backend


def resolve_projection(path: str | None = None,
                       regularization: str | None = None,
                       device: torch.device | None = None, *,
                       dtype: str = "*", shape=None,
                       plan: ExecutionPlan | None = None) -> str:
  """Projection path: ``path=`` > ``REPRO_TORCH_PROJECTION`` > plans."""
  if path and path != "auto" and path not in PROJECTION_PATHS:
    raise ValueError(f"projection path must be one of {PROJECTION_PATHS}, "
                     f"got {path!r}")
  platform = "cpu" if device is None else torch.device(device).type
  return _resolve("projection", "projection", regularization, path,
                  platform, dtype, shape, plan)


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
             *args: torch.Tensor,
             plan: ExecutionPlan | None = None) -> torch.Tensor:
  """Route a batched forward pass to the resolved backend.

  All ``args`` share one shape whose last axis is the problem dimension.
  The backend call runs under a ``repro_<op>_<reg>_<backend>`` profiler
  range.
  """
  x = args[0]
  shape = x.shape
  b = resolve(op, regularization, backend, x.device,
              dtype=dtype_name(x.dtype), shape=shape, plan=plan)
  flat, orig_dtype = _promote_flat(args, shape[-1])
  with _tracing.backend_scope(op, regularization, b):
    out = _REGISTRY[(op, regularization, b)](*flat)
  return _restore(out, shape, orig_dtype)


def dispatch_backward(op: str, regularization: str, backend: str | None,
                      *args: torch.Tensor,
                      plan: ExecutionPlan | None = None):
  """Route a batched VJP to the resolved backward backend.

  Same flattening and promote/demote contract as ``dispatch``; the impl
  may return one gradient or a tuple of them, each restored to the batch
  shape.  Runs under a ``repro_<op>_bwd_<reg>_<backend>`` range.
  """
  x = args[0]
  shape = x.shape
  b = resolve_backward(op, regularization, backend, x.device,
                       dtype=dtype_name(x.dtype), shape=shape, plan=plan)
  flat, orig_dtype = _promote_flat(args, shape[-1])
  with _tracing.backend_scope(f"{op}_bwd", regularization, b):
    out = _BWD_REGISTRY[(op, regularization, b)](*flat)
  return _restore(out, shape, orig_dtype)


def dispatch_projection(z: torch.Tensor, w: torch.Tensor, regularization: str,
                        impl: str | None, path: str | None = None,
                        plan: ExecutionPlan | None = None,
                        **kwargs) -> torch.Tensor:
  """Route a permutahedron projection to the fused or composed pipeline.

  Implementations own their batching (the fused path sorts an unbatched
  ``w`` once for the whole batch), so ``z`` and ``w`` pass unflattened;
  ``kwargs`` carry the sortedness hints and precomputed permutations.
  """
  p = resolve_projection(path, regularization, z.device,
                         dtype=dtype_name(z.dtype), shape=z.shape, plan=plan)
  fn = _REGISTRY.get(("projection", regularization, p))
  if fn is None:
    raise ValueError(
        f"no projection path {p!r} registered for "
        f"regularization={regularization!r} (import "
        f"repro_torch.core.projection)")
  with _tracing.backend_scope("projection", regularization, p):
    return fn(z, w, impl, plan=plan, **kwargs)


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

register_backward("isotonic", "l2", "segscan")(_svjp.isotonic_l2_bwd_segscan)
register_backward("isotonic", "l2", "scatter")(_svjp.isotonic_l2_bwd_scatter)
register_backward("isotonic", "kl", "segscan")(_svjp.isotonic_kl_bwd_segscan)
register_backward("isotonic", "kl", "scatter")(_svjp.isotonic_kl_bwd_scatter)

# Forward projection paths ("fused" / "composed") register themselves on
# ``repro_torch.core.projection`` import: kernels must not import core.
register_backward("projection", "l2",
                  "segscan")(_svjp.projection_l2_bwd_segscan)
register_backward("projection", "l2",
                  "scatter")(_svjp.projection_l2_bwd_scatter)
register_backward("projection", "kl",
                  "segscan")(_svjp.projection_kl_bwd_segscan)
register_backward("projection", "kl",
                  "scatter")(_svjp.projection_kl_bwd_scatter)
