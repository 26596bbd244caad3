"""Attribution scopes for dispatched backend calls.

Counterpart of ``repro.obs.tracing`` (``scope_name`` / ``backend_scope``).
``backend_scope`` is a ``torch.profiler.record_function`` range, so a
profiler trace attributes the kernels a backend launches to
``repro_<op>_<reg>_<backend>``, the names the JAX reference gives its named
scopes.  Scope names are ``[a-z0-9_]`` only.  ``trace_annotation`` names a
host-side region the same way.
"""

from __future__ import annotations

import re

import torch

_SANITIZE = re.compile(r"[^a-z0-9_]+")


def _clean(part: str) -> str:
  return _SANITIZE.sub("_", str(part).lower()).strip("_") or "unknown"


def scope_name(op: str, regularization: str, backend: str) -> str:
  """Canonical profiler range name for a dispatched backend call."""
  return f"repro_{_clean(op)}_{_clean(regularization)}_{_clean(backend)}"


def backend_scope(op: str, regularization: str, backend: str):
  """Profiler range labelling everything a backend call launches."""
  return torch.profiler.record_function(scope_name(op, regularization,
                                                   backend))


def trace_annotation(name: str):
  """Profiler range around a host-side region (``repro_serve_engine``, a
  timed benchmark loop)."""
  return torch.profiler.record_function(name)
