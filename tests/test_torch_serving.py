"""The port's serving engine (``repro_torch.serving``) against the
reference's (``repro.serving``).

Bucket policy, the cell cache's counters, admission control with typed
shedding, the engine's ``step()`` under an injected clock, typed errors,
and end to end: a warmed engine serves a mixed-n stream with zero
``aot_cache_miss`` and results bit for bit equal to the unpadded port
calls on the same backend (``stack`` and ``scan`` on the CPU).  The
engine's stream and policies are the reference's: the same seed gives the
same requests, the same ladders and the same queue decisions.

Tolerances: vector results bitwise; scalar results within 1e-5 relative of
the unpadded loss; the stream's values exactly.  Small sizes (buckets 8 to
64, batches of at most 8, tens of requests).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_common import cuda_device  # noqa: E402,F401

import repro.serving as jserving  # noqa: E402
from repro_torch import plan as plan_mod  # noqa: E402
from repro_torch.core import soft_lts_loss, soft_rank, soft_sort  # noqa: E402
from repro_torch.kernels import dispatch, ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.obs import artifacts, metrics  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AOTExecutableCache,
    AdmissionQueue,
    BucketPolicy,
    EngineConfig,
    Request,
    SERVING_OPS,
    STATUS_ERROR,
    STATUS_OK,
    STATUS_SHED_DEADLINE,
    STATUS_SHED_QUEUE_FULL,
    ServingEngine,
    synthetic_stream,
)

rng = np.random.default_rng(31)


@pytest.fixture(autouse=True)
def clean_metrics(monkeypatch):
  monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
  plan_mod.set_active_plan(None)
  metrics.set_enabled(True)
  metrics.reset()
  yield
  plan_mod.set_active_plan(None)
  metrics.set_enabled(None)
  metrics.reset()


class FakeClock:
  def __init__(self, t=100.0):
    self.t = t

  def __call__(self):
    return self.t


def _req(n=5, op="soft_rank/l2/desc", **kw):
  return Request(op=op, values=rng.standard_normal(n).astype(np.float32),
                 eps=0.5, **kw)


def _engine(clock=None, **kw):
  kw.setdefault("ops", ("soft_rank/l2/desc",))
  kw.setdefault("min_bucket", 8)
  kw.setdefault("max_bucket", 16)
  kw.setdefault("device", "cpu")
  return ServingEngine(EngineConfig(**kw), clock=clock or FakeClock())


# ---------------------------------------------------------------------------
# Bucket policy: the reference's ladders.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("min_n,max_n,max_batch", [(64, 4096, 32),
                                                   (8, 100, 8), (5, 5, 1)])
def test_bucket_policy_matches_reference(min_n, max_n, max_batch):
  got = BucketPolicy.pow2(min_n, max_n, max_batch)
  want = jserving.BucketPolicy.pow2(min_n, max_n, max_batch)
  assert (got.sizes, got.row_sizes) == (want.sizes, want.row_sizes)
  for n in range(1, max_n + 1, 7):
    assert got.bucket_for(n) == want.bucket_for(n)
  with pytest.raises(ValueError, match="exceeds the largest bucket"):
    got.bucket_for(max_n + 1)
  with pytest.raises(ValueError, match=">= 1"):
    got.bucket_for(0)
  assert got.rows_for(max_batch) == max_batch


def test_bucket_policy_from_plan_splices_breakpoints():
  plan = plan_mod.ExecutionPlan(name="edges", rules=(
      plan_mod.PlanRule("forward", "minimax", max_n=100, max_elems=10**6),
      plan_mod.PlanRule("forward", "scan", min_n=3000),
  ))
  p = BucketPolicy.from_plan(plan, min_n=64, max_n=4096, max_batch=4)
  assert 100 in p.sizes and 2999 in p.sizes
  assert p.bucket_for(70) == 100 and p.bucket_for(101) == 128
  # The built-in plan has no size rule: the ladder stays pow2.
  assert BucketPolicy.from_plan(None, min_n=64, max_n=4096).sizes == \
      BucketPolicy.pow2(64, 4096).sizes


# ---------------------------------------------------------------------------
# The cell cache.
# ---------------------------------------------------------------------------


def test_cache_hit_miss_warm_evict_counters():
  cache = AOTExecutableCache(capacity=2)
  builds = []

  def builder(tag):
    def build():
      builds.append(tag)
      return ("cell", tag)
    return build

  assert cache.warm("a", builder("a")) is True
  assert cache.warm("a", builder("a")) is False
  assert cache.get("a", builder("a")) == ("cell", "a")
  assert cache.get("b", builder("b")) == ("cell", "b")
  assert cache.get("c", builder("c")) == ("cell", "c")   # evicts "a"
  assert len(cache) == 2 and "a" not in cache and builds == ["a", "b", "c"]
  c = metrics.counters()
  assert (c["aot_cache_warm"], c["aot_cache_hit"], c["aot_cache_miss"],
          c["aot_cache_evict"]) == (1, 1, 2, 1)
  cache.get("b", builder("b"))                           # refresh "b"
  cache.get("d", builder("d"))                           # evicts "c"
  assert "b" in cache and "c" not in cache


# ---------------------------------------------------------------------------
# Admission.
# ---------------------------------------------------------------------------


def test_queue_rejects_on_full_and_pops_fifo_groups():
  q = AdmissionQueue(capacity=3, clock=FakeClock())
  a, b, c, d = _req(3), _req(4), _req(3, op="soft_sort/l2/desc"), _req(5)
  for r in (a, b, c, d):
    r.bucket_n = 64
  assert all(q.try_push(r) for r in (a, b, c))
  assert not q.try_push(d)
  assert q.head_group_size() == 2
  assert [r.request_id for r in q.pop_group(8)] == [a.request_id,
                                                    b.request_id]
  assert len(q) == 1


def test_queue_deadline_expiry():
  fc = FakeClock()
  q = AdmissionQueue(capacity=8, clock=fc)
  r1, r2 = _req(3), _req(3)
  r1.submitted_at = r2.submitted_at = fc.t
  r1.deadline_at = fc.t + 0.005
  q.try_push(r1)
  q.try_push(r2)
  assert q.expire() == []
  fc.t += 0.006
  assert [r.request_id for r in q.expire()] == [r1.request_id]
  assert len(q) == 1


# ---------------------------------------------------------------------------
# The engine: typed outcomes and the batching policy.
# ---------------------------------------------------------------------------


def test_engine_sheds_on_a_full_queue_and_on_deadlines():
  fc = FakeClock()
  eng = _engine(fc, max_batch=2, queue_capacity=2, max_wait_ms=1000.0)
  h = [eng.submit(_req(5, deadline_ms=5.0)), eng.submit(_req(5)),
       eng.submit(_req(5))]
  assert not h[0].done() and not h[1].done()
  assert h[2].result(0).status == STATUS_SHED_QUEUE_FULL
  fc.t += 0.006
  stepped = eng.step()
  assert stepped[0].status == STATUS_SHED_DEADLINE
  assert h[0].result(0).latency_us == pytest.approx(6000.0, rel=0.01)
  assert metrics.counter_value("serving_shed", reason="queue_full") == 1
  assert metrics.counter_value("serving_shed", reason="deadline") == 1
  assert metrics.counter_value("serving_admit", op="soft_rank") == 2


def test_engine_invalid_requests_are_typed_errors():
  eng = _engine(max_batch=2)
  bad = eng.submit(_req(5, op="nope/l2"))
  assert bad.result(0).status == STATUS_ERROR
  assert "unknown serving op" in bad.result(0).detail
  big = eng.submit(_req(999))
  assert big.result(0).status == STATUS_ERROR
  assert "exceeds the largest bucket" in big.result(0).detail
  assert metrics.counter_value("serving_shed", reason="invalid") == 2


def test_engine_turns_an_execution_failure_into_error_results(monkeypatch):
  """An exception while running a batch finishes every request of the
  batch as ``error`` and counts ``serving_error``; the engine goes on."""
  eng = _engine(max_batch=2, impl="stack")
  calls = []

  def boom(fn, args):
    calls.append(len(args))
    raise RuntimeError("kernel launch failed")

  monkeypatch.setattr(eng, "_run", boom)
  handles = [eng.submit(_req(5)), eng.submit(_req(6))]
  results = eng.step()
  assert [r.status for r in results] == [STATUS_ERROR] * 2
  assert all(h.result(0).status == STATUS_ERROR for h in handles)
  assert "RuntimeError: kernel launch failed" in handles[0].result(0).detail
  assert metrics.counter_value("serving_error", op="soft_rank") == 1
  monkeypatch.undo()
  h = eng.submit(_req(4))
  eng.drain()
  assert h.result(0).ok


def test_engine_max_wait_and_max_batch_policy():
  fc = FakeClock()
  eng = _engine(fc, min_bucket=8, max_bucket=8, max_batch=2, impl="stack",
                max_wait_ms=10.0)
  h1 = eng.submit(_req(5))
  assert eng.step() == [] and len(eng.queue) == 1    # not yet due
  fc.t += 0.02
  assert [r.status for r in eng.step()] == [STATUS_OK]
  assert h1.result(0).ok and metrics.counter_value("aot_cache_miss") == 1
  h2, h3 = eng.submit(_req(6)), eng.submit(_req(7))  # a full group is due
  assert len(eng.step()) == 2 and h2.result(0).ok and h3.result(0).ok
  assert metrics.counter_value("aot_cache_miss") == 2   # a 2-row cell
  eng.submit(_req(3))
  eng.submit(_req(8))
  eng.step()
  assert metrics.counter_value("aot_cache_hit") == 1
  occ = metrics.histograms("serving_batch_occupancy")
  assert sum(h["count"] for h in occ.values()) == 3
  assert metrics.counter_value("serving_batch_exec", op="soft_rank",
                               regularization="l2") == 3


def test_engine_defaults_to_the_card():
  if torch.cuda.is_available():
    pytest.skip("a card is present: the default device runs")
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    ServingEngine(EngineConfig())
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    serve.main(["--engine", "--engine-requests", "1"])


# ---------------------------------------------------------------------------
# End to end: warm-up, a mixed stream, exact results, no misses.
# ---------------------------------------------------------------------------


def _unpadded(req: Request, impl: str):
  x = torch.from_numpy(np.asarray(req.values))
  if req.op.startswith("soft_rank"):
    return soft_rank(x, req.eps, "l2", impl=impl).numpy()
  return soft_sort(x, req.eps, "kl", impl=impl).numpy()


@pytest.mark.parametrize("impl", ["stack", "scan"])
def test_engine_end_to_end_bitwise_and_zero_miss(impl):
  cfg = EngineConfig(ops=("soft_rank/l2/desc", "soft_sort/kl/desc"),
                     min_bucket=8, max_bucket=64, max_batch=8,
                     max_wait_ms=0.0, impl=impl, device="cpu")
  eng = ServingEngine(cfg)
  assert eng.warmup() == 2 * 4 * 4           # ops x n-buckets x row-buckets
  assert eng.warmup() == 0                   # already resident
  reqs = synthetic_stream(24, seed=4, ops=cfg.ops, n_min=8, n_max=64)
  results = eng.serve(reqs)
  assert all(r.ok for r in results)
  for req, res in zip(reqs, results):
    assert res.n == req.n and res.bucket_n >= req.n
    np.testing.assert_array_equal(res.value, _unpadded(req, impl))
  assert metrics.counter_value("aot_cache_miss") == 0
  assert metrics.counter_value("aot_cache_warm") == 32
  assert metrics.counters("aot_cache_hit")
  lat = metrics.histograms("serving_latency_us")
  assert sum(h["count"] for h in lat.values()) == len(reqs)


def test_engine_on_the_builtin_route_labels_its_cells():
  """Without ``impl`` the cells carry the plan chain's backend for the
  engine's device: ``stack`` on the CPU."""
  eng = _engine(max_batch=2)
  eng.warmup()
  assert {k[1] for k in eng.cache.keys()} == {"stack"}
  h = eng.submit(_req(11))
  eng.drain()
  np.testing.assert_array_equal(h.result(0).value, soft_rank(
      torch.from_numpy(h.values), h.eps).numpy())


def test_engine_scalar_op_matches_unpadded_loss(monkeypatch):
  eng = _engine(ops=("lts/l2",), max_batch=2, impl="scan")
  vals = rng.standard_normal(11).astype(np.float32)
  h = eng.submit(Request(op="lts/l2", values=vals, eps=0.7,
                         extras={"trim": 3}))
  eng.drain()
  res = h.result(timeout=0)
  assert res.ok and isinstance(res.value, float)
  monkeypatch.setenv(dispatch.ENV_VAR, "scan")
  want = float(soft_lts_loss(torch.from_numpy(vals), 3, 0.7, "l2"))
  assert res.value == pytest.approx(want, rel=1e-5)


def test_engine_background_thread_smoke():
  import time
  eng = _engine(max_batch=4, impl="stack", max_wait_ms=1.0)
  eng.clock = eng.queue.clock = time.monotonic
  eng.start()
  try:
    handles = [eng.submit(_req(n)) for n in (4, 9, 13)]
    results = [h.result(timeout=30.0) for h in handles]
  finally:
    eng.stop()
  assert all(r.ok for r in results)


def test_synthetic_stream_is_the_references():
  ops_ = tuple(sorted(SERVING_OPS))
  got = synthetic_stream(30, seed=5, ops=ops_, n_min=8, n_max=64)
  want = jserving.synthetic_stream(30, seed=5, ops=ops_, n_min=8, n_max=64)
  for a, b in zip(got, want):
    assert (a.op, a.n, a.eps) == (b.op, b.n, b.eps)
    np.testing.assert_array_equal(a.values, b.values)
    assert sorted(a.extras) == sorted(b.extras)
    for k in a.extras:
      np.testing.assert_array_equal(a.extras[k], b.extras[k])


def test_engine_cli_on_the_cpu_writes_a_valid_artifact(tmp_path, capsys):
  """``--engine --device cpu``: the reference's ``[engine]`` lines, zero
  misses, no kernel launch, an artifact both validators accept."""
  from repro.obs import artifacts as jartifacts
  path = tmp_path / "BENCH_engine.json"
  before = ops.all_launches()
  res = serve.main(["--engine", "--device", "cpu", "--engine-requests", "20",
                    "--engine-min-n", "8", "--engine-max-n", "32",
                    "--engine-max-batch", "4", "--bench-json", str(path)])
  out = capsys.readouterr().out
  assert "[engine] warmed 18 cells" in out and "served 20/20" in out
  assert "aot_cache_miss=0" in out and "p50/p95/p99" in out
  assert res["ok"] == 20 and res["shed"] == 0 and res["aot_cache_miss"] == 0
  assert ops.all_launches() == before
  assert artifacts.validate_file(str(path)) == []
  assert jartifacts.validate_file(str(path)) == []


@pytest.mark.requires_cuda
def test_engine_on_the_card_is_bitwise_and_launches_once_a_batch(
    cuda_device):
  from repro_torch.kernels import pav
  cfg = EngineConfig(ops=("soft_rank/l2/desc", "soft_sort/kl/desc"),
                     min_bucket=64, max_bucket=256, max_batch=8,
                     max_wait_ms=0.0)
  eng = ServingEngine(cfg)
  pav.reset_launches()
  cells = eng.warmup()
  assert {k[1] for k in eng.cache.keys()} == {"cuda"}
  reqs = synthetic_stream(40, seed=6, ops=cfg.ops, n_min=64, n_max=256)
  results = eng.serve(reqs)
  torch.cuda.synchronize()
  batches = {reg: metrics.counter_value("serving_batch_exec", op=op,
                                        regularization=reg)
             for op, reg in (("soft_rank", "l2"), ("soft_sort", "kl"))}
  assert pav.LAUNCHES["pav_l2"] == cells // 2 + batches["l2"]
  assert pav.LAUNCHES["pav_kl"] == cells // 2 + batches["kl"]
  for req, res in zip(reqs, results):
    assert res.ok
    x = torch.from_numpy(req.values).to(cuda_device)
    reg = "l2" if req.op.startswith("soft_rank") else "kl"
    fn = soft_rank if reg == "l2" else soft_sort
    np.testing.assert_array_equal(res.value, fn(x, req.eps, reg).cpu())
