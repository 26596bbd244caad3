"""Process-local metrics registry: counters and histograms with labels.

Counterpart of ``repro.obs.metrics``, a copy in the standard library only
(the port imports nothing of the JAX package).  ``REPRO_TORCH_METRICS=0``
(or ``false`` / ``off`` / ``no``) turns every recording call into one
predicate check that keeps no state.  A metric instance is named
``name{k=v,...}`` with its label keys sorted, so snapshots are stable
across runs.  The trainer observes ``train_step_us``; the dispatch layer
counts every call (``dispatch_calls``, ``dispatch_shape`` by
``shape_bucket``, ``dispatch_bwd_calls``, ``projection_fused_calls``) and
every resolution.  Modules that keep state beside the registry (the
dispatch layer's memo of counter names) register an ``on_reset`` hook,
so that a disabled process keeps nothing.

A counter's increment may be a 0-d device tensor (``counter_inc``): the
sum then stays on the device, added with no host sync, and becomes an int
only where the registry is read (``counters``, ``counter_value``,
``snapshot``).  The MoE layer counts so, and only while a profiler records
(``tracing.recording()``), so its counts cover exactly a traced segment:
``moe_slots``, the G x E x C capacity slots of each ``moe_apply`` call,
and ``moe_slots_filled``, the slots a token took.
"""

from __future__ import annotations

import math
import os
import threading
from typing import Callable

ENV_VAR = "REPRO_TORCH_METRICS"

_FALSY = ("0", "false", "off", "no")

_lock = threading.Lock()
# An int, or a 0-d device tensor where an increment was one.
_counters: dict = {}
_histograms: dict[str, dict] = {}
# None -> consult the environment on each call; True/False -> forced.
_enabled_override: bool | None = None
# Run by reset() (and so by set_enabled(False)): state that other modules
# keep beside the registry.
_reset_hooks: list[Callable[[], None]] = []


def enabled() -> bool:
  """True if recording is on (the default; ``REPRO_TORCH_METRICS=0`` opts
  out)."""
  if _enabled_override is not None:
    return _enabled_override
  return os.environ.get(ENV_VAR, "1").strip().lower() not in _FALSY


def set_enabled(on: bool | None) -> None:
  """Force recording on or off; ``None`` defers to the environment.
  Turning it off also drops everything recorded."""
  global _enabled_override
  _enabled_override = on
  if on is False:
    reset()


def on_reset(hook: Callable[[], None]) -> None:
  """Register ``hook`` to run on every ``reset()``."""
  _reset_hooks.append(hook)


def reset() -> None:
  """Clear every counter and histogram, and run the ``on_reset`` hooks."""
  with _lock:
    _counters.clear()
    _histograms.clear()
  for hook in _reset_hooks:
    hook()


def _key(name: str, labels: dict) -> str:
  if not labels:
    return name
  inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
  return f"{name}{{{inner}}}"


def key(name: str, /, **labels) -> str:
  """The flattened instance name ``name{k=v,...}`` of a counter."""
  return _key(name, labels)


def bump(*flat_keys: str) -> None:
  """Increment by one each counter whose flattened name (``key``) was
  formatted once beforehand: the dispatch hot path's ``counter_inc``."""
  if not enabled():
    return
  with _lock:
    for k in flat_keys:
      _counters[k] = _counters.get(k, 0) + 1


def counter_inc(name: str, value=1, /, **labels) -> None:
  """Increment counter ``name{labels}`` by ``value`` (no-op when off): an
  int, or a 0-d device tensor, which is added on the device."""
  if not enabled():
    return
  k = _key(name, labels)
  with _lock:
    _counters[k] = _counters.get(k, 0) + value


def counter_value(name: str, /, **labels) -> int:
  """Current value of a counter (0 if never incremented)."""
  return int(_counters.get(_key(name, labels), 0))


def pow2_bucket(value: float) -> str:
  """Histogram bucket label: the smallest power of two >= value."""
  v = max(float(value), 0.0)
  if v <= 1.0:
    return "<=2^0"
  return f"<=2^{math.ceil(math.log2(v))}"


def shape_bucket(rows: int, n: int) -> str:
  """A label for a flattened (rows, n) problem shape, few and stable:
  ``r2^3_n2^7`` for at most 8 rows of n <= 128 (no commas, which separate
  labels in a flattened name)."""
  return f"r{pow2_bucket(rows)[2:]}_n{pow2_bucket(n)[2:]}"


def observe(name: str, value: float, /, **labels) -> None:
  """Record ``value`` into histogram ``name{labels}`` (no-op when off):
  count, sum, min, max and power-of-two bucket counts."""
  if not enabled():
    return
  k = _key(name, labels)
  with _lock:
    h = _histograms.get(k)
    if h is None:
      h = {"count": 0, "sum": 0.0, "min": math.inf, "max": -math.inf,
           "buckets": {}}
      _histograms[k] = h
    h["count"] += 1
    h["sum"] += float(value)
    h["min"] = min(h["min"], float(value))
    h["max"] = max(h["max"], float(value))
    b = pow2_bucket(value)
    h["buckets"][b] = h["buckets"].get(b, 0) + 1


def counters(prefix: str = "") -> dict[str, int]:
  """Flattened ``name{labels}`` -> value (optionally prefix-filtered); a
  count kept on the device is read here."""
  with _lock:
    found = [(k, v) for k, v in sorted(_counters.items())
             if k.startswith(prefix)]
  return {k: int(v) for k, v in found}


def histograms(prefix: str = "") -> dict[str, dict]:
  """Flattened histograms; ``min``/``max`` are None while empty."""
  out = {}
  with _lock:
    for k in sorted(_histograms):
      if not k.startswith(prefix):
        continue
      h = _histograms[k]
      out[k] = {
          "count": h["count"],
          "sum": h["sum"],
          "min": h["min"] if h["count"] else None,
          "max": h["max"] if h["count"] else None,
          "buckets": dict(sorted(h["buckets"].items())),
      }
  return out


def snapshot() -> dict:
  """JSON-serializable snapshot of the whole registry."""
  return {"enabled": enabled(), "counters": counters(),
          "histograms": histograms()}
