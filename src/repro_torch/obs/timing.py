"""Wall-clock timing: the one implementation the drivers use.

Counterpart of ``repro.obs.timing``.  Every timing is a wall time with the
device synchronised around the timed call (``torch.cuda.synchronize`` on
the device of the tensors the call returns; nothing on the CPU), so the
numbers are end-to-end per-call latencies, not launch times.  When metrics
are on, each measurement of ``time_fn`` is also observed into the
``bench_us`` histogram.
"""

from __future__ import annotations

import math
import time
from typing import Callable

import torch

from repro_torch.obs import metrics
from repro_torch.obs.tracing import trace_annotation


def _devices(tree, out: set) -> set:
  if isinstance(tree, torch.Tensor):
    if tree.device.type == "cuda":
      out.add(tree.device)
  elif isinstance(tree, (list, tuple)):
    for t in tree:
      _devices(t, out)
  elif isinstance(tree, dict):
    for t in tree.values():
      _devices(t, out)
  return out


def block_until_ready(tree):
  """Wait for the devices of every CUDA tensor in ``tree`` (tensors,
  lists, tuples, dicts); returns ``tree``."""
  for device in _devices(tree, set()):
    torch.cuda.synchronize(device)
  return tree


def timed(fn: Callable, *args) -> tuple[object, float]:
  """Run ``fn(*args)`` with the devices synchronised around it:
  (result, seconds)."""
  block_until_ready(args)
  t0 = time.perf_counter()
  out = block_until_ready(fn(*args))
  return out, time.perf_counter() - t0


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 5,
            name: str | None = None) -> float:
  """Median wall time per call in microseconds.

  ``warmup`` calls (kernel builds, allocator growth) are excluded.  When
  ``name`` is given and metrics are on, every measured call is observed
  into histogram ``bench_us{name=...}``.
  """
  for _ in range(warmup):
    block_until_ready(fn(*args))
  times = []
  with trace_annotation(f"repro_bench_{name}" if name else "repro_bench"):
    for _ in range(iters):
      _, dt = timed(fn, *args)
      times.append(dt)
  if name is not None:
    for dt in times:
      metrics.observe("bench_us", dt * 1e6, name=name)
  times.sort()
  return times[len(times) // 2] * 1e6


def time_fns(calls: dict[str, tuple[Callable, tuple]], *, warmup: int = 2,
             iters: int = 5, name: str | None = None) -> dict[str, float]:
  """Median wall time per call in microseconds of each ``fn(*args)`` of
  ``calls`` (key -> (fn, args)), their calls alternating: every fn's
  ``warmup`` calls, then ``iters`` rounds that time each fn once in turn.

  A change of the host's load between rounds lands on every fn alike, so
  the ratios of the medians hold where medians taken one fn after another
  drift apart (eager calls on the card are host-bound).  When ``name`` is
  given and metrics are on, each measured call is observed into
  ``bench_us{name=<name>/<key>}``.
  """
  for fn, args in calls.values():
    for _ in range(warmup):
      block_until_ready(fn(*args))
  times: dict[str, list[float]] = {key: [] for key in calls}
  with trace_annotation(f"repro_bench_{name}" if name else "repro_bench"):
    for _ in range(iters):
      for key, (fn, args) in calls.items():
        times[key].append(timed(fn, *args)[1])
  out = {}
  for key, samples in times.items():
    if name is not None:
      for dt in samples:
        metrics.observe("bench_us", dt * 1e6, name=f"{name}/{key}")
    samples.sort()
    out[key] = samples[len(samples) // 2] * 1e6
  return out


def percentiles(samples, qs=(50, 95, 99)) -> tuple[float, ...]:
  """Nearest-rank percentiles of a sample list (sorted or not): observed
  values, no interpolation.  Empty input gives zeros."""
  if not samples:
    return tuple(0.0 for _ in qs)
  ordered = sorted(samples)
  out = []
  for q in qs:
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    out.append(float(ordered[min(rank, len(ordered)) - 1]))
  return tuple(out)


class wall_timer:
  """Context manager: ``with wall_timer() as t: ...; t.seconds / t.us``."""

  def __enter__(self):
    self._t0 = time.perf_counter()
    self.seconds = 0.0
    return self

  def __exit__(self, *exc):
    self.seconds = time.perf_counter() - self._t0
    return False

  @property
  def us(self) -> float:
    return self.seconds * 1e6
