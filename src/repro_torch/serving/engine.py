"""The micro-batching serving engine.

Counterpart of ``repro.serving.engine``.  Data path::

    submit(Request)                       # admission: bounded queue
      -> shape bucket (BucketPolicy)      # pad target for this n
      -> micro-batch (max-wait/max-batch) # group = (op-variant, bucket)
      -> warmed cell (AOTExecutableCache) # bound padded op, plan-labelled
      -> repro_torch.kernels.dispatch     # backend resolved per call
      -> ServeResult (typed; sliced back to the request's n)

Everything per request rides as per-row tensors (values, true_n, eps, k,
trim, ...), so one cell per ``(op-variant, rows, bucket)`` serves any
parameter mix; the padding of :mod:`repro_torch.serving.ops` is exact.

A batch is assembled in numpy, moved to the engine's device with one copy
per array, run under ``torch.inference_mode()`` (the fused projection
saves no residuals) and brought back with one copy; results are sliced on
the host.  On the card a batch is a few copies and one PAV kernel launch.
The engine runs on the card (``EngineConfig.device="cuda"``, the default,
raising where there is none) unless the caller asks for the CPU.

The engine is synchronous-first: ``step()`` advances one micro-batch and
is what the tests drive deterministically (with an injected clock);
``start()``/``stop()`` wrap the same step loop in a background thread;
``serve()`` runs a whole request stream with backpressure.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch import plan as plan_mod
from repro_torch.obs import metrics
from repro_torch.serving.admission import (
    AdmissionQueue,
    Request,
    ServeResult,
    STATUS_ERROR,
    STATUS_OK,
    STATUS_SHED_DEADLINE,
    STATUS_SHED_QUEUE_FULL,
)
from repro_torch.serving.aot_cache import AOTExecutableCache
from repro_torch.serving.bucketing import BucketPolicy
from repro_torch.serving.ops import (
    EXTRA_SCALAR,
    OpSpec,
    SERVING_OPS,
    bound_op,
    padded_op,
)

DTYPE = "float32"

#: Default extras for pad rows (true_n=1, eps=1): valid for every op.
_EXTRA_DEFAULTS = {"k": 1, "trim": 0}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
  """Tunables of one :class:`ServingEngine` instance."""

  ops: tuple[str, ...] = ("soft_rank/l2/desc", "soft_sort/l2/desc")
  min_bucket: int = 64
  max_bucket: int = 4096
  max_batch: int = 64
  max_wait_ms: float = 2.0
  queue_capacity: int = 1024
  default_deadline_ms: float | None = None
  aot_capacity: int = 256
  impl: str | None = None         # pin a backend; None = resolution chain
  device: str = "cuda"            # "cuda" (the card) or "cpu"

  def __post_init__(self):
    for key in self.ops:
      if key not in SERVING_OPS:
        raise ValueError(f"unknown serving op {key!r}; expected keys from "
                         f"repro_torch.serving.SERVING_OPS (e.g. "
                         f"{sorted(SERVING_OPS)[:4]} ...)")
    if self.max_batch < 1:
      raise ValueError("max_batch must be >= 1")


def engine_device(name: str) -> torch.device:
  """The device of ``EngineConfig.device``: the card, raising where there
  is none, or the CPU."""
  device = torch.device(name)
  if device.type not in ("cpu", "cuda"):
    raise ValueError(f"unknown device {name!r}")
  if device.type == "cuda":
    if not torch.cuda.is_available():
      raise RuntimeError("CUDA is not available: the serving engine runs on "
                         "the card (EngineConfig(device='cpu') or --device "
                         "cpu runs it on the CPU)")
    if device.index is None:
      device = torch.device("cuda", torch.cuda.current_device())
  return device


class ServingEngine:
  """Shape-bucketed dynamic batcher over the padded op family."""

  def __init__(self, config: EngineConfig | None = None, *,
               plan: "plan_mod.ExecutionPlan | None" = None,
               clock=time.monotonic):
    self.config = config or EngineConfig()
    self.device = engine_device(self.config.device)
    self.plan = plan
    self.clock = clock
    self.policy = BucketPolicy.from_plan(
        plan, min_n=self.config.min_bucket, max_n=self.config.max_bucket,
        max_batch=self.config.max_batch)
    self.cache = AOTExecutableCache(self.config.aot_capacity)
    self.queue = AdmissionQueue(self.config.queue_capacity, clock=clock)
    self._step_lock = threading.Lock()
    self._backend_label: dict[tuple[str, int, int], str] = {}
    self._thread: threading.Thread | None = None
    self._running = False

  # -- cells ------------------------------------------------------------------

  def _backend_for(self, spec: OpSpec, rows: int, bucket_n: int) -> str:
    """The isotonic backend a cell runs: the pinned ``impl``, else the
    plan chain's decision for this device and shape."""
    if self.config.impl is not None:
      return self.config.impl
    key = (spec.regularization, rows, bucket_n)
    label = self._backend_label.get(key)
    if label is None:
      cell = plan_mod.resolve_grid(
          "forward", ["isotonic"], [spec.regularization],
          [(rows, bucket_n)], platform=self.device.type, dtype=DTYPE,
          plan=self.plan)
      label = cell[0]["backend"]
      self._backend_label[key] = label
    return label

  def _cell_key(self, spec: OpSpec, rows: int, bucket_n: int):
    backend = self._backend_for(spec, rows, bucket_n)
    return (spec.key, backend, rows, bucket_n, DTYPE)

  def _dummy_args(self, spec: OpSpec, rows: int, bucket_n: int):
    """Host arrays of a batch of pad rows (true_n=1, eps=1)."""
    args = [np.zeros((rows, bucket_n), np.float32),
            np.ones((rows,), np.int32), np.ones((rows,), np.float32)]
    for name, dtype, kind in spec.extras:
      if kind == EXTRA_SCALAR:
        args.append(np.full((rows,), _EXTRA_DEFAULTS.get(name, 0),
                            np.dtype(dtype)))
      else:
        args.append(np.zeros((rows, bucket_n), np.dtype(dtype)))
    return args

  def _run(self, fn, host_args) -> np.ndarray:
    """One copy to the device per array, the op under inference mode, one
    copy back."""
    dev_args = [torch.from_numpy(a).to(self.device) for a in host_args]
    with torch.inference_mode():
      out = fn(*dev_args)
    return out.cpu().numpy()

  def _builder(self, spec: OpSpec, rows: int, bucket_n: int):
    def build():
      fn = bound_op(spec.key, self.config.impl, self.plan)
      self._run(fn, self._dummy_args(spec, rows, bucket_n))
      return fn
    return build

  def warmup(self, ops: Sequence[str] | None = None,
             sizes: Sequence[int] | None = None,
             row_sizes: Sequence[int] | None = None) -> int:
    """Warm every (op, rows, bucket) cell the policy can route to: run it
    once on the device.  The enumeration comes from the bucket policy,
    which derives from the governing plan, so a covered request stream
    misses zero times afterwards.  Returns the number of cells built."""
    built = 0
    for key in (ops or self.config.ops):
      spec = padded_op(key)
      for bucket_n in (sizes or self.policy.sizes):
        for rows in (row_sizes or self.policy.row_sizes):
          if self.cache.warm(self._cell_key(spec, rows, bucket_n),
                             self._builder(spec, rows, bucket_n)):
            built += 1
    return built

  # -- admission --------------------------------------------------------------

  def submit(self, req: Request) -> Request:
    """Admit one request; always returns the handle with a typed outcome
    (possibly already finished as shed or error: never an exception for
    load conditions)."""
    now = self.clock()
    req.submitted_at = now
    deadline_ms = (req.deadline_ms if req.deadline_ms is not None
                   else self.config.default_deadline_ms)
    req.deadline_at = None if deadline_ms is None else now + deadline_ms / 1e3
    try:
      spec = padded_op(req.op)
      req.bucket_n = self.policy.bucket_for(req.n)
    except (KeyError, ValueError) as e:
      metrics.counter_inc("serving_shed", reason="invalid")
      req.finish(ServeResult(STATUS_ERROR, req.request_id, req.op, req.n,
                             detail=str(e)))
      return req
    if not self.queue.try_push(req):
      metrics.counter_inc("serving_shed", reason="queue_full")
      req.finish(ServeResult(STATUS_SHED_QUEUE_FULL, req.request_id, req.op,
                             req.n, bucket_n=req.bucket_n,
                             detail="admission queue at capacity"))
      return req
    metrics.counter_inc("serving_admit", op=spec.op)
    return req

  # -- the batcher ------------------------------------------------------------

  def step(self, flush: bool = False) -> list[ServeResult]:
    """Advance the engine: expire deadlines, then run one micro-batch if
    the max-wait/max-batch policy says so (always, under ``flush``).

    Returns the results finished by this step (callers normally read
    per-request handles instead)."""
    with self._step_lock:
      now = self.clock()
      results: list[ServeResult] = []
      for req in self.queue.expire(now):
        metrics.counter_inc("serving_shed", reason="deadline")
        res = ServeResult(STATUS_SHED_DEADLINE, req.request_id, req.op,
                          req.n, bucket_n=req.bucket_n,
                          latency_us=(now - req.submitted_at) * 1e6,
                          detail="deadline expired in queue")
        req.finish(res)
        results.append(res)
      metrics.observe("serving_queue_depth", len(self.queue))
      head_age = self.queue.head_age(now)
      if head_age is None:
        return results
      due = (flush or head_age * 1e3 >= self.config.max_wait_ms
             or self.queue.head_group_size() >= self.config.max_batch)
      if not due:
        return results
      batch = self.queue.pop_group(self.config.max_batch)
      if batch:
        results.extend(self._execute(batch))
      return results

  def _assemble(self, spec: OpSpec, batch: list[Request], rows: int,
                bucket_n: int) -> list[np.ndarray]:
    """The batch's host arrays: its requests' rows, then pad rows."""
    args = self._dummy_args(spec, rows, bucket_n)
    values, true_n, eps, extras = args[0], args[1], args[2], args[3:]
    for i, req in enumerate(batch):
      n = req.n
      values[i, :n] = np.asarray(req.values, np.float32)
      true_n[i] = n
      eps[i] = req.eps
      for slot, (name, dtype, kind) in zip(extras, spec.extras):
        if name not in req.extras:
          continue
        if kind == EXTRA_SCALAR:
          slot[i] = req.extras[name]
        else:
          slot[i, :n] = np.asarray(req.extras[name], np.dtype(dtype))
    return args

  def _execute(self, batch: list[Request]) -> list[ServeResult]:
    spec = padded_op(batch[0].op)
    bucket_n = batch[0].bucket_n
    m = len(batch)
    rows = self.policy.rows_for(m)
    try:
      args = self._assemble(spec, batch, rows, bucket_n)
      fn = self.cache.get(self._cell_key(spec, rows, bucket_n),
                          self._builder(spec, rows, bucket_n))
      out = self._run(fn, args)
    except Exception as e:  # typed errors, not exceptions, per contract
      metrics.counter_inc("serving_error", op=spec.op)
      results = []
      for req in batch:
        res = ServeResult(STATUS_ERROR, req.request_id, req.op, req.n,
                          bucket_n=bucket_n, rows=rows,
                          detail=f"{type(e).__name__}: {e}")
        req.finish(res)
        results.append(res)
      return results
    done = self.clock()
    metrics.observe("serving_batch_occupancy", 100.0 * m / rows, op=spec.op)
    real = float(sum(r.n for r in batch))
    metrics.observe("serving_padding_waste",
                    100.0 * (1.0 - real / (rows * bucket_n)), op=spec.op)
    metrics.counter_inc("serving_batch_exec", op=spec.op,
                        regularization=spec.regularization)
    results = []
    for i, req in enumerate(batch):
      value = (out[i, :req.n] if spec.output == "vector"
               else float(out[i]))
      latency_us = (done - req.submitted_at) * 1e6
      metrics.observe("serving_latency_us", latency_us, op=spec.op)
      res = ServeResult(STATUS_OK, req.request_id, req.op, req.n,
                        value=value, latency_us=latency_us,
                        bucket_n=bucket_n, rows=rows)
      req.finish(res)
      results.append(res)
    return results

  def drain(self) -> list[ServeResult]:
    """Flush until the queue is empty (expiries included)."""
    results: list[ServeResult] = []
    while len(self.queue):
      results.extend(self.step(flush=True))
    return results

  def serve(self, requests: Iterable[Request], *,
            backpressure: bool = True) -> list[ServeResult]:
    """Run a whole request stream; returns results in submission order.

    With ``backpressure`` (default) a full queue makes the caller wait by
    stepping the engine instead of shedding (the closed-loop throughput
    mode).  Without it, admission behaves exactly like ``submit``
    (reject-on-full)."""
    handles = []
    for req in requests:
      if backpressure:
        while len(self.queue) >= self.queue.capacity:
          self.step(flush=True)
      handles.append(self.submit(req))
      self.step()
    self.drain()
    return [h.result(timeout=0.0) for h in handles]

  # -- background thread ------------------------------------------------------

  def start(self) -> None:
    """Run the step loop in a daemon thread (push-style serving)."""
    if self._thread is not None:
      return
    self._running = True
    tick = min(max(self.config.max_wait_ms / 4e3, 0.0002), 0.01)

    def loop():
      while self._running:
        if not self.step():
          time.sleep(tick)

    self._thread = threading.Thread(target=loop, name="repro-torch-serving",
                                    daemon=True)
    self._thread.start()

  def stop(self, drain: bool = True) -> None:
    if self._thread is None:
      return
    self._running = False
    self._thread.join(timeout=10.0)
    self._thread = None
    if drain:
      self.drain()


# ---------------------------------------------------------------------------
# Synthetic traffic (smoke, demos).
# ---------------------------------------------------------------------------


def synthetic_stream(num_requests: int, *, seed: int = 0,
                     ops: Sequence[str] = ("soft_rank/l2/desc",
                                           "soft_sort/l2/desc"),
                     n_min: int = 64, n_max: int = 4096,
                     deadline_ms: float | None = None) -> list[Request]:
  """A Zipf-ish mixed-size request stream (sizes skew small, heavy tail up
  to ``n_max``) over the given op variants: the reference's stream for the
  same arguments."""
  rng = np.random.default_rng(seed)
  out = []
  for _ in range(num_requests):
    # u^2 skews the log-uniform draw toward small n (Zipf-flavored).
    u = rng.random() ** 2
    n = int(round(n_min * (n_max / n_min) ** u))
    n = int(np.clip(n, n_min, n_max))
    key = ops[int(rng.integers(len(ops)))]
    spec = padded_op(key)
    values = rng.standard_normal(n).astype(np.float32)
    extras: dict = {}
    for name, dtype, kind in spec.extras:
      if name == "k":
        extras["k"] = int(rng.integers(1, max(2, n // 4)))
      elif name == "trim":
        extras["trim"] = int(rng.integers(0, max(1, n // 4)))
      elif name == "target":
        extras["target"] = rng.permutation(n).astype(np.float32) + 1.0
      elif name == "w":
        extras["w"] = rng.standard_normal(n).astype(np.float32)
    out.append(Request(op=key, values=values,
                       eps=float(10 ** rng.uniform(-1.0, 0.5)),
                       extras=extras, deadline_ms=deadline_ms))
  return out
