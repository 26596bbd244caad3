"""Spans: named ranges on the profiler's timeline, recorded only while a
profiler records.

Counterpart of ``repro.obs.tracing`` (``scope_name`` / ``backend_scope``).
``span(name)`` is a ``torch.profiler.record_function`` range while a
``torch.profiler`` session records (``recording()``): the range's name,
its start and end on the profiler's clock, which is the device trace's
clock too, and, by nesting, its parent span; a kernel launched inside it
is attributed to it on the thread that launched it (autograd's device
thread for a backward).  With no profiler recording, ``span`` returns one
shared null context, so a span costs one check.

``backend_scope`` labels everything a dispatched backend call launches
with ``repro_<op>_<reg>_<backend>``, the names the JAX reference gives its
named scopes; scope names are ``[a-z0-9_]`` only.  ``trace_annotation``
names a host-side region (a timed benchmark loop) the same way.
"""

from __future__ import annotations

import contextlib
import re

import torch
from torch.autograd import _profiler_enabled as recording

_SANITIZE = re.compile(r"[^a-z0-9_]+")
_OFF = contextlib.nullcontext()


def _clean(part: str) -> str:
  return _SANITIZE.sub("_", str(part).lower()).strip("_") or "unknown"


def scope_name(op: str, regularization: str, backend: str) -> str:
  """Canonical profiler range name for a dispatched backend call."""
  return f"repro_{_clean(op)}_{_clean(regularization)}_{_clean(backend)}"


def span(name: str):
  """A profiler range ``name`` while a profiler records (``recording()``),
  else one shared null context."""
  if not recording():
    return _OFF
  return torch.profiler.record_function(name)


def backend_scope(op: str, regularization: str, backend: str):
  """The span labelling everything a backend call launches; its name is
  built only while a profiler records."""
  if not recording():
    return _OFF
  return torch.profiler.record_function(scope_name(op, regularization,
                                                   backend))


def trace_annotation(name: str):
  """The span around a host-side region (a timed benchmark loop)."""
  return span(name)
