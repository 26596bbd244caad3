"""Process-local metrics registry: counters and histograms with labels.

Counterpart of ``repro.obs.metrics``, a copy in the standard library only
(the port imports nothing of the JAX package).  ``REPRO_TORCH_METRICS=0``
(or ``false`` / ``off`` / ``no``) turns every recording call into one
predicate check that keeps no state.  A metric instance is named
``name{k=v,...}`` with its label keys sorted, so snapshots are stable
across runs.  The trainer observes ``train_step_us``.
"""

from __future__ import annotations

import math
import os
import threading

ENV_VAR = "REPRO_TORCH_METRICS"

_FALSY = ("0", "false", "off", "no")

_lock = threading.Lock()
_counters: dict[str, int] = {}
_histograms: dict[str, dict] = {}
# None -> consult the environment on each call; True/False -> forced.
_enabled_override: bool | None = None


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


def reset() -> None:
  """Clear every counter and histogram."""
  with _lock:
    _counters.clear()
    _histograms.clear()


def _key(name: str, labels: dict) -> str:
  if not labels:
    return name
  inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
  return f"{name}{{{inner}}}"


def key(name: str, /, **labels) -> str:
  """The flattened instance name ``name{k=v,...}`` of a counter."""
  return _key(name, labels)


def bump(flat_key: str) -> None:
  """Increment the counter whose flattened name (``key``) was formatted
  once beforehand: the dispatch hot path's ``counter_inc``."""
  if not enabled():
    return
  with _lock:
    _counters[flat_key] = _counters.get(flat_key, 0) + 1


def counter_inc(name: str, value: int = 1, /, **labels) -> None:
  """Increment counter ``name{labels}`` by ``value`` (no-op when off)."""
  if not enabled():
    return
  k = _key(name, labels)
  with _lock:
    _counters[k] = _counters.get(k, 0) + value


def counter_value(name: str, /, **labels) -> int:
  """Current value of a counter (0 if never incremented)."""
  return _counters.get(_key(name, labels), 0)


def pow2_bucket(value: float) -> str:
  """Histogram bucket label: the smallest power of two >= value."""
  v = max(float(value), 0.0)
  if v <= 1.0:
    return "<=2^0"
  return f"<=2^{math.ceil(math.log2(v))}"


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
  """Flattened ``name{labels}`` -> value (optionally prefix-filtered)."""
  with _lock:
    return {k: v for k, v in sorted(_counters.items())
            if k.startswith(prefix)}


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
