"""Admission control: typed requests/results and the bounded queue.

Counterpart of ``repro.serving.admission``.  Load-shedding is part of
the result type, never an exception: a request that cannot be served
returns a :class:`ServeResult` whose ``status`` says why
(``shed_queue_full`` at admission when the bounded queue is full;
``shed_deadline`` when its deadline expires while queued).  The engine's
counters mirror the statuses (``serving_admit``,
``serving_shed{reason=...}``).
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any

import numpy as np

STATUS_OK = "ok"
STATUS_SHED_QUEUE_FULL = "shed_queue_full"
STATUS_SHED_DEADLINE = "shed_deadline"
STATUS_ERROR = "error"

_ids = itertools.count()


@dataclasses.dataclass
class Request:
  """One serving request: a single row of arbitrary length ``n``.

  ``op`` is a :data:`repro_torch.serving.ops.SERVING_OPS` key (e.g.
  ``"soft_rank/l2/desc"``); ``extras`` carries the op's per-request
  parameters (``k``, ``trim`` scalars; ``target``, ``w`` length-n
  vectors).  ``deadline_ms`` is a relative budget from submission;
  the engine stamps the absolute expiry on admission.
  """

  op: str
  values: np.ndarray
  eps: float = 1.0
  extras: dict[str, Any] = dataclasses.field(default_factory=dict)
  deadline_ms: float | None = None

  # Engine-stamped state.
  request_id: int = dataclasses.field(default_factory=lambda: next(_ids))
  bucket_n: int = 0
  submitted_at: float = 0.0
  deadline_at: float | None = None
  _done: threading.Event = dataclasses.field(
      default_factory=threading.Event, repr=False, compare=False)
  _result: "ServeResult | None" = dataclasses.field(
      default=None, repr=False, compare=False)

  @property
  def n(self) -> int:
    return int(np.asarray(self.values).shape[-1])

  @property
  def group(self) -> tuple[str, int]:
    """Micro-batching key: requests batch together per (op, bucket)."""
    return (self.op, self.bucket_n)

  def finish(self, result: "ServeResult") -> None:
    self._result = result
    self._done.set()

  def result(self, timeout: float | None = None) -> "ServeResult":
    """Block until served/shed; raises TimeoutError if not done in time."""
    if not self._done.wait(timeout):
      raise TimeoutError(f"request {self.request_id} not finished "
                         f"within {timeout}s")
    assert self._result is not None
    return self._result

  def done(self) -> bool:
    return self._done.is_set()


@dataclasses.dataclass
class ServeResult:
  """Typed outcome of one request (statuses: ``ok``, ``shed_queue_full``,
  ``shed_deadline``, ``error`` — shedding is data, not an exception)."""

  status: str
  request_id: int
  op: str
  n: int
  value: Any = None          # (n,) numpy array for vector ops, float for losses
  latency_us: float | None = None
  bucket_n: int | None = None
  rows: int | None = None    # batch rows of the executable that served it
  detail: str = ""

  @property
  def ok(self) -> bool:
    return self.status == STATUS_OK


class AdmissionQueue:
  """Bounded FIFO with group-aware draining and deadline expiry.

  Thread-safe; all methods take the internal lock.  ``clock`` is
  injectable (tests pin it) and defaults to ``time.monotonic``.
  """

  def __init__(self, capacity: int, clock=time.monotonic):
    if capacity < 1:
      raise ValueError(f"queue capacity must be >= 1, got {capacity}")
    self.capacity = capacity
    self.clock = clock
    self._items: list[Request] = []
    self._lock = threading.Lock()

  def __len__(self) -> int:
    return len(self._items)

  def try_push(self, req: Request) -> bool:
    """Admit ``req``; False (reject-on-full) when at capacity."""
    with self._lock:
      if len(self._items) >= self.capacity:
        return False
      self._items.append(req)
      return True

  def expire(self, now: float | None = None) -> list[Request]:
    """Remove and return every queued request whose deadline has passed."""
    now = self.clock() if now is None else now
    with self._lock:
      expired = [r for r in self._items
                 if r.deadline_at is not None and now > r.deadline_at]
      if expired:
        dead = set(id(r) for r in expired)
        self._items = [r for r in self._items if id(r) not in dead]
      return expired

  def head_age(self, now: float | None = None) -> float | None:
    """Seconds the oldest queued request has waited (None when empty)."""
    with self._lock:
      if not self._items:
        return None
      now = self.clock() if now is None else now
      return now - self._items[0].submitted_at

  def head_group_size(self) -> int:
    """How many queued requests share the oldest request's group key."""
    with self._lock:
      if not self._items:
        return 0
      key = self._items[0].group
      return sum(1 for r in self._items if r.group == key)

  def pop_group(self, max_batch: int) -> list[Request]:
    """Dequeue up to ``max_batch`` requests sharing the head's group key.

    FIFO across groups: the oldest request picks the group, and only
    requests in that group leave the queue (others keep their order).
    """
    with self._lock:
      if not self._items:
        return []
      key = self._items[0].group
      taken: list[Request] = []
      rest: list[Request] = []
      for r in self._items:
        if r.group == key and len(taken) < max_batch:
          taken.append(r)
        else:
          rest.append(r)
      self._items = rest
      return taken
