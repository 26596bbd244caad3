"""Bounded LRU of the engine's warmed cells.

Counterpart of ``repro.serving.aot_cache``.  The reference compiles each
``(op-variant, rows, bucket_n, dtype)`` cell ahead of time
(``jax.jit(fn).lower(...).compile()``).  PyTorch has no such executable, so
a cell here is the bound callable of its padded op (``serving.ops.
bound_op``), keyed by ``(op key, backend, rows, bucket_n, dtype)``, and
warming a cell runs that callable once on the device on dummy rows: on the
card that builds the kernels' library at its first use and grows the
allocator to the cell's size, so the first real batch of the cell pays
neither.  CUDA graphs of the warmed cells are later work.

Counters (``repro_torch.obs.metrics``), with the reference's meaning:

* ``aot_cache_hit``: the cell is resident;
* ``aot_cache_miss``: the cell was built on the request path (a warm-up
  gap: after warming every cell the policy can route to, a stream misses
  zero times);
* ``aot_cache_warm``: built by explicit warm-up (not a miss);
* ``aot_cache_evict``: LRU eviction under the capacity bound.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Hashable

from repro_torch.obs import metrics


class AOTExecutableCache:
  """LRU mapping hashable keys -> warmed cells (thread-safe)."""

  def __init__(self, capacity: int = 128):
    if capacity < 1:
      raise ValueError(f"capacity must be >= 1, got {capacity}")
    self.capacity = capacity
    self._entries: "collections.OrderedDict[Hashable, object]" = (
        collections.OrderedDict())
    self._lock = threading.Lock()

  def __len__(self) -> int:
    return len(self._entries)

  def __contains__(self, key: Hashable) -> bool:
    return key in self._entries

  def keys(self):
    return list(self._entries)

  def get(self, key: Hashable, builder: Callable[[], object]) -> object:
    """The cell for ``key``, built via ``builder()`` on a miss."""
    with self._lock:
      exe = self._entries.get(key)
      if exe is not None:
        self._entries.move_to_end(key)
        metrics.counter_inc("aot_cache_hit")
        return exe
    # Build outside the lock; a racing duplicate build is wasteful but
    # correct (last insert wins).
    metrics.counter_inc("aot_cache_miss")
    exe = builder()
    self._insert(key, exe)
    return exe

  def warm(self, key: Hashable, builder: Callable[[], object]) -> bool:
    """Populate ``key`` ahead of traffic; True if a build happened.

    Warm-up builds count as ``aot_cache_warm``, not misses, so a non-zero
    ``aot_cache_miss`` after warm-up always means the request stream hit a
    cell that warm-up did not enumerate.
    """
    with self._lock:
      if key in self._entries:
        self._entries.move_to_end(key)
        return False
    metrics.counter_inc("aot_cache_warm")
    exe = builder()
    self._insert(key, exe)
    return True

  def _insert(self, key: Hashable, exe: object) -> None:
    with self._lock:
      self._entries[key] = exe
      self._entries.move_to_end(key)
      while len(self._entries) > self.capacity:
        self._entries.popitem(last=False)
        metrics.counter_inc("aot_cache_evict")

  def clear(self) -> None:
    with self._lock:
      self._entries.clear()
