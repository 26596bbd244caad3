"""The reference's per-call dispatch counters and the public names the
port had lacked, against the reference.

Counters: ``dispatch_calls{op,regularization,backend}`` and
``dispatch_shape{op,bucket}`` a forward call, ``dispatch_bwd_calls`` a
backward, and a projection's ``dispatch_calls{op=projection,...}`` with
``projection_fused_calls`` on the fused path
(``src/repro/kernels/dispatch.py:439-442, 469-474, 500``).  The
reference's own sequences (``tests/test_obs.py:33-46``,
``tests/test_plan.py:224-245``, ``tests/test_projection_fused.py:215-225``)
run eagerly through both packages, where the reference can run them (its
composed projection), and every counter but the reference's trace-cache
ones must be equal, name, labels and count, with its backend names mapped
to the port's (``lax`` -> ``stack``, ``pallas`` -> ``cuda``).  The fused
path raises fault R1 in the reference after it has counted the
projection: there the port is held to what those lines record, and the
reference's projection counters up to the fault are held to the port's.
Exact comparisons throughout: counts and strings.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import plan as jplan  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import permutations as jperm  # noqa: E402
from repro.core import soft_rank as jsoft_rank  # noqa: E402
from repro.core import soft_sort as jsoft_sort  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro_torch import plan as plan_mod  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core import permutations, soft_rank, soft_sort  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.serving import EngineConfig, ServingEngine, \
    synthetic_stream  # noqa: E402

BACKEND_NAMES = {"lax": "stack", "pallas": "cuda"}
PER_CALL = ("dispatch_calls{", "dispatch_shape{", "dispatch_bwd_calls{",
            "projection_fused_calls{")


@pytest.fixture
def registries(monkeypatch):
  """Both registries on and empty; the reference's projections composed
  (fault R1), the port's by the argument or the environment each test
  sets."""
  for var in ("REPRO_METRICS", metrics.ENV_VAR, "REPRO_BACKEND",
              "REPRO_BACKWARD", dispatch.ENV_VAR, dispatch.BWD_ENV_VAR,
              dispatch.PROJECTION_ENV_VAR):
    monkeypatch.delenv(var, raising=False)
  monkeypatch.setenv("REPRO_PROJECTION", "composed")
  for reg in (jmetrics, metrics):
    reg.set_enabled(True)
    reg.reset()
  yield monkeypatch
  for reg in (jmetrics, metrics):
    reg.set_enabled(None)
    reg.reset()


def _mapped(counters: dict) -> dict:
  """The reference's counters in the port's names: its backends renamed,
  its trace-cache counters (JAX traces, which the port has none of)
  dropped."""
  out = {}
  for key, n in counters.items():
    if key.startswith("dispatch_trace_cache"):
      continue
    for ref, port in BACKEND_NAMES.items():
      key = key.replace(f"backend={ref},", f"backend={port},")
    out[key] = n
  return out


def _per_call(counters: dict) -> dict:
  return {k: v for k, v in counters.items() if k.startswith(PER_CALL)}


def test_counters_increment_per_dispatch_as_the_references(registries):
  """``tests/test_obs.py:33-46``: two forward calls at (3, 8) with the
  backend named (``lax``; the port's ``stack``)."""
  registries.setenv(dispatch.PROJECTION_ENV_VAR, "composed")
  x = np.random.default_rng(11).normal(size=(3, 8)).astype(np.float32)
  for _ in range(2):
    jsoft_rank(jnp.asarray(x), 0.5, "l2", impl="lax")
    soft_rank(torch.from_numpy(x), 0.5, "l2", impl="stack")
  got, want = metrics.counters(), _mapped(jmetrics.counters())
  assert got == want
  assert got["dispatch_calls{backend=stack,op=isotonic,"
             "regularization=l2}"] == 2
  assert got["dispatch_shape{bucket=r2^2_n2^3,op=isotonic}"] == 2
  assert got["dispatch_calls{backend=composed,op=projection,"
             "regularization=l2}"] == 2
  assert "dispatch_bwd_calls" not in str(got)


@pytest.mark.parametrize("path", ["composed", "fused"])
def test_plan_pinned_counters_under_grad(registries, path):
  """``tests/test_plan.py:224-245``: a plan pins the forward (minimax),
  the backward (scatter) and the projection path; the gradient of
  ``soft_rank(x).sum()`` at (3, 12) (the reference's ``plan=``; the
  port's operators take the plan by ``use_plan``).  Composed: both
  packages, every counter equal.  Fused (fault R1 in the reference): the port's per-call
  counters as the reference's lines record them, one of each."""
  x = np.random.default_rng(12).normal(size=(3, 12)).astype(np.float32)

  def rules(mod):
    return (mod.PlanRule("forward", "minimax"),
            mod.PlanRule("backward", "scatter"),
            mod.PlanRule("projection", path, op="projection"))

  pinned = plan_mod.ExecutionPlan(name="jit-pin", rules=rules(plan_mod))
  registries.delenv("REPRO_PROJECTION")
  xt = torch.from_numpy(x).requires_grad_(True)
  with plan_mod.use_plan(pinned):
    torch.autograd.grad(soft_rank(xt).sum(), xt)
  got = metrics.counters()
  bwd_op = "isotonic" if path == "composed" else "projection"
  want_per_call = {
      "dispatch_calls{backend=minimax,op=isotonic,regularization=l2}": 1,
      "dispatch_shape{bucket=r2^2_n2^4,op=isotonic}": 1,
      f"dispatch_calls{{backend={path},op=projection,regularization=l2}}": 1,
      f"dispatch_bwd_calls{{backend=scatter,op={bwd_op},"
      f"regularization=l2}}": 1}
  if path == "fused":
    want_per_call["projection_fused_calls{regularization=l2}"] = 1
  assert _per_call(got) == want_per_call
  if path == "composed":
    jpinned = jplan.ExecutionPlan(name="jit-pin", rules=rules(jplan))
    jax.grad(lambda a: jsoft_rank(a, plan=jpinned).sum())(jnp.asarray(x))
    assert got == _mapped(jmetrics.counters())


def test_fused_calls_counter_as_the_references_records_it(registries):
  """``tests/test_projection_fused.py:215-225``: ``soft_rank`` on the
  default (fused) path.  The reference counts the projection and then
  raises fault R1; the port records those counters alike, then its
  isotonic solve's (the CPU's built-in ``stack``)."""
  theta = np.random.default_rng(13).normal(size=(2, 8)).astype(np.float32)
  registries.delenv("REPRO_PROJECTION")
  with pytest.raises(AttributeError, match="enable_x64"):
    jsoft_rank(jnp.asarray(theta), 0.5, "l2")
  soft_rank(torch.from_numpy(theta), 0.5, "l2")
  got = _per_call(metrics.counters())
  assert got == {
      "dispatch_calls{backend=fused,op=projection,regularization=l2}": 1,
      "projection_fused_calls{regularization=l2}": 1,
      "dispatch_calls{backend=stack,op=isotonic,regularization=l2}": 1,
      "dispatch_shape{bucket=r2^1_n2^3,op=isotonic}": 1}
  assert metrics.counter_value("projection_fused_calls",
                               regularization="l2") >= 1
  assert {k: v for k, v in got.items() if "op=projection" in k
          or k.startswith("projection_fused")} == _per_call(
              _mapped(jmetrics.counters()))


@pytest.mark.parametrize("source", ["arg", "env", "plan"])
def test_every_call_counts_whatever_chose_the_backend(registries, source):
  """The per-call counts do not depend on where the backend came from
  (the memoized keys: with a plan's decision, or by (kind, op,
  regularization, backend, rows, n)); l2 and kl, forward and backward,
  over shapes in two buckets (one shape twice), against the same calls in the reference."""
  rng = np.random.default_rng(14)
  xs = [rng.normal(size=shape).astype(np.float32)
        for shape in ((4, 16), (4, 16), (2, 3, 40))]
  registries.setenv(dispatch.PROJECTION_ENV_VAR, "composed")
  impl, jimpl = ("stack", "lax") if source == "arg" else (None, None)
  if source == "env":
    registries.setenv(dispatch.ENV_VAR, "stack")
    registries.setenv("REPRO_BACKEND", "lax")
  ctx, jctx = contextlib.nullcontext(), contextlib.nullcontext()
  if source == "plan":
    ctx = dispatch.use_backend("stack")
    jctx = jplan.use_plan(jplan.ExecutionPlan(
        name="forward=lax", rules=(jplan.PlanRule("forward", "lax"),)))
  with ctx, jctx:
    for x in xs:
      for reg in ("l2", "kl"):
        xt = torch.from_numpy(x).requires_grad_(True)
        torch.autograd.grad(soft_sort(xt, 0.5, reg, impl=impl).sum(), xt)
        jax.grad(lambda a, r=reg: jnp.sum(jsoft_sort(a, 0.5, r, impl=jimpl)))(
            jnp.asarray(x))
  got = _per_call(metrics.counters())
  assert got == _per_call(_mapped(jmetrics.counters()))
  for reg in ("l2", "kl"):
    assert got[f"dispatch_calls{{backend=stack,op=isotonic,"
               f"regularization={reg}}}"] == len(xs)
    assert got[f"dispatch_bwd_calls{{backend=segscan,op=isotonic,"
               f"regularization={reg}}}"] == len(xs)
  assert got["dispatch_shape{bucket=r2^2_n2^4,op=isotonic}"] == 4
  assert got["dispatch_shape{bucket=r2^3_n2^6,op=isotonic}"] == 2


def test_disabled_metrics_record_nothing(registries):
  """``REPRO_TORCH_METRICS=0``: calls with the backend from an argument,
  the environment and a plan record no counter, and the memo of counter
  names stays empty."""
  registries.setenv(metrics.ENV_VAR, "0")
  metrics.set_enabled(None)
  dispatch._CALL_KEYS.clear()
  x = torch.randn(3, 10, requires_grad=True)
  for impl in ("stack", None):
    torch.autograd.grad(soft_rank(x, 0.5, "l2", impl=impl).sum(), x)
  registries.setenv(dispatch.ENV_VAR, "scan")
  torch.autograd.grad(soft_rank(x, 0.5, "kl").sum(), x)
  assert metrics.snapshot() == {"enabled": False, "counters": {},
                                "histograms": {}}
  assert dispatch._CALL_KEYS == {}
  registries.delenv(metrics.ENV_VAR)
  soft_rank(x, 0.5, "l2", impl="stack")
  assert dispatch._CALL_KEYS
  metrics.set_enabled(False)         # forcing off drops the memo too
  assert dispatch._CALL_KEYS == {} and metrics.counters() == {}


def test_engine_counts_one_solve_a_batch_and_a_warmed_cell(registries):
  """The serving engine on the CPU: ``dispatch_calls`` of its isotonic
  solves equal the executed batches plus the warmed cells, the count
  the card's launch counters are held to."""
  cfg = EngineConfig(ops=("soft_rank/l2/desc", "soft_sort/kl/desc"),
                     min_bucket=8, max_bucket=64, max_batch=8,
                     max_wait_ms=0.0, impl="stack", device="cpu")
  eng = ServingEngine(cfg)
  cells = eng.warmup()
  reqs = synthetic_stream(24, seed=4, ops=cfg.ops, n_min=8, n_max=64)
  assert all(r.ok for r in eng.serve(reqs))
  batches = sum(metrics.counters("serving_batch_exec").values())
  solves = sum(v for k, v in metrics.counters("dispatch_calls{").items()
               if "op=isotonic" in k)
  assert solves == cells + batches and batches > 0
  assert sum(metrics.counters("dispatch_shape{").values()) == solves


# ---------------------------------------------------------------------------
# Public names.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [0, 1, 2, 3, 4, 5, 8, 9, 127, 128, 129,
                                  65535, 65536, 70000])
def test_shape_bucket_is_the_references(rows):
  for n in (0, 1, 2, 3, 7, 8, 9, 64, 65, 1000, 4096, 2**20):
    assert metrics.shape_bucket(rows, n) == jmetrics.shape_bucket(rows, n)
  assert metrics.shape_bucket(3, 8) == "r2^2_n2^3"
  assert metrics.shape_bucket(0, 1) == "r2^0_n2^0"


def test_on_reset_runs_its_hooks():
  seen = []
  metrics.on_reset(lambda: seen.append(1))
  metrics.reset()
  metrics.set_enabled(False)
  metrics.set_enabled(None)
  assert seen == [1, 1]
  metrics._reset_hooks.pop()


@pytest.mark.parametrize("shape, dim", [((17,), -1), ((3, 40), -1),
                                        ((3, 40), 0), ((2, 5, 9), 1)])
def test_argsort_ascending_is_the_references_on_ties(shape, dim):
  """Stable: tied values keep their order, as ``jnp.argsort(stable=True)``
  does; int64 against the reference's int32."""
  x = np.round(np.random.default_rng(15).normal(size=shape) * 2) / 2
  got = permutations.argsort_ascending(torch.from_numpy(x), dim=dim)
  want = jperm.argsort_ascending(jnp.asarray(x), axis=dim)
  assert got.dtype == torch.int64
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  # Not the descending order reversed, which puts ties last index first.
  assert not torch.equal(got, permutations.argsort_descending(
      torch.from_numpy(x), dim=dim).flip(dim))


def test_argsort_ascending_detaches():
  x = torch.tensor([2.0, 1.0, 2.0, 0.5], requires_grad=True)
  idx = permutations.argsort_ascending(x)
  assert idx.tolist() == [3, 1, 0, 2] and not idx.requires_grad


def test_all_assigned_is_the_references_list():
  got = base.all_assigned()
  assert got == jbase.all_assigned() and got == list(base.ASSIGNED)
  assert all(name in base.registered() for name in got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embed_init_shape_dtype_and_seed(dtype):
  def draw(seed):
    gen = torch.Generator().manual_seed(seed)
    return layers.embed_init(gen, 50, 12, dtype, "cpu")

  p = draw(3)
  assert list(p) == ["table"]
  t = p["table"]
  assert t.shape == (50, 12) and t.dtype == dtype and t.device.type == "cpu"
  assert torch.equal(t, draw(3)["table"])
  assert not torch.equal(t, draw(4)["table"])
  assert abs(float(t.float().std()) - 0.02) < 0.004
  assert tuple(layers.embed_init(torch.Generator(), 32000, 2048, dtype,
                                 "meta")["table"].shape) == (32000, 2048)


def test_embed_init_is_the_models_table():
  """``init_params`` draws its table through ``embed_init``: the same
  generator state gives the same table."""
  from repro_torch.configs.smoke import smoke_config
  from repro_torch.models import transformer as T
  cfg = smoke_config("tinyllama-1.1b")
  model = T.init_params(cfg, 7)
  gen = torch.Generator().manual_seed(7)
  want = layers.embed_init(gen, cfg.vocab_size, cfg.d_model, T.dtype_of(cfg),
                           "cpu")["table"]
  assert torch.equal(model.embed.table.detach(), want)
