"""The port's execution plans (``repro_torch.plan``) against the reference's
(``repro.plan``), and the port's resolution chain in ``kernels.dispatch``.

Plans are data, so the comparison is exact: the same JSON parses to the
same rules and the same ``plan_hash`` in both packages, a malformed file
is refused by both, and the same plan makes the same decisions
(``resolve_grid``, ``shape_breakpoints``).  The built-in plan encodes the
port's own routes (f64 on the card -> scan, the card -> cuda, the CPU ->
stack; scatter on the card, segscan elsewhere; fused).  Values computed
under a plan are held to the port's unpinned call at 1e-5 * (1 + max|x|)
(``test_torch_common``).
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_common import (  # noqa: E402,F401
    as_torch, assert_close, no_packaged_plan, packaged_plan)

from repro import plan as jplan  # noqa: E402
from repro_torch import plan as plan_mod  # noqa: E402
from repro_torch.core import projection_permutahedron, soft_rank  # noqa: E402
from repro_torch.kernels import dispatch as D  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REFERENCE_PLAN = ROOT / "src" / "repro" / "plan" / "default_plan.json"
CPU, GPU = torch.device("cpu"), torch.device("cuda", 0)
rng = np.random.default_rng(29)


@pytest.fixture(autouse=True)
def clean_state(monkeypatch):
  """No environment overrides, no active plan, fresh metrics."""
  for var in (D.ENV_VAR, D.BWD_ENV_VAR, D.PROJECTION_ENV_VAR):
    monkeypatch.delenv(var, raising=False)
  plan_mod.set_active_plan(None)
  metrics.set_enabled(True)
  metrics.reset()
  yield
  plan_mod.set_active_plan(None)
  metrics.set_enabled(None)
  metrics.reset()


def _pin(kind: str, backend: str, name: str = "pinned"):
  return plan_mod.ExecutionPlan(name=name,
                                rules=(plan_mod.PlanRule(kind, backend),))


# ---------------------------------------------------------------------------
# The built-in plan.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,op,reg,platform,dtype,want", [
    ("forward", "isotonic", "l2", "cuda", "float64", "scan"),   # F2
    ("forward", "isotonic", "kl", "cuda", "float64", "scan"),
    ("forward", "isotonic", "l2", "cuda", "float32", "cuda"),
    ("forward", "isotonic", "kl", "cuda", "bfloat16", "cuda"),
    ("forward", "isotonic", "l2", "cuda", "*", "cuda"),
    ("forward", "isotonic", "l2", "cpu", "float64", "stack"),
    ("forward", "isotonic", "kl", "cpu", "float32", "stack"),
    ("backward", "projection", "l2", "cuda", "float32", "scatter"),
    ("backward", "isotonic", "kl", "cpu", "float32", "segscan"),
    ("projection", "projection", "l2", "cuda", "float32", "fused"),
    ("projection", "projection", "kl", "cpu", "float64", "fused"),
])
def test_builtin_plan_routes(no_packaged_plan, kind, op, reg, platform,
                            dtype, want):
  backend, source, _ = plan_mod.resolve_via_plans(
      kind, op, reg, platform=platform, dtype=dtype, shape=(128, 1000))
  assert (backend, source) == (want, "builtin")
  assert plan_mod.default_plan() is None        # isolated: none packaged


PACKAGED_SHAPES = [(1, 64), (128, 1000), (4096, 64), (2048, 64), (1, 2048),
                   (32, 4096), (128, 10000), None]


def test_packaged_plan_loads_with_card_f32_rules_only():
  """The shipped plan parses strictly (the chain's loader swallows
  errors, so load it directly) and keys every rule to the card's f32
  solves, each citing measured rows."""
  packaged = plan_mod.load_plan(plan_mod.DEFAULT_PLAN_PATH)
  assert plan_mod.default_plan() == packaged
  assert packaged.name == "autotuned-cuda"
  assert packaged.meta["platform"] == "cuda"
  assert {r.kind for r in packaged.rules} == set(plan_mod.KINDS)
  for rule in packaged.rules:
    assert (rule.platform, rule.dtype) == ("cuda", "float32"), rule
    assert rule.evidence, rule


@pytest.mark.parametrize("kind,op,reg,platform,dtype,want", [
    ("forward", "isotonic", "l2", "cuda", "float64", "scan"),   # F2
    ("forward", "isotonic", "kl", "cuda", "float64", "scan"),
    ("forward", "isotonic", "kl", "cuda", "bfloat16", "cuda"),
    ("forward", "isotonic", "l2", "cuda", "*", "cuda"),
    ("forward", "isotonic", "l2", "cpu", "float32", "stack"),
    ("forward", "isotonic", "kl", "cpu", "float64", "stack"),
    ("backward", "isotonic", "l2", "cpu", "float32", "segscan"),
    ("backward", "projection", "kl", "cuda", "float64", "scatter"),
    ("projection", "projection", "kl", "cpu", "float32", "fused"),
    ("projection", "projection", "l2", "cuda", "float64", "fused"),
])
def test_packaged_plan_leaves_cpu_and_other_dtypes_as_before(
    kind, op, reg, platform, dtype, want):
  """Every query the packaged plan does not key (the CPU, f64 and bf16 on
  the card) resolves as the built-in plan does, at every shape."""
  assert plan_mod.default_plan() is not None
  for shape in PACKAGED_SHAPES:
    backend, source, _ = plan_mod.resolve_via_plans(
        kind, op, reg, platform=platform, dtype=dtype, shape=shape)
    assert (backend, source) == (want, "builtin"), shape


@pytest.mark.parametrize("kind,op", [("forward", "isotonic"),
                                     ("backward", "projection"),
                                     ("backward", "isotonic"),
                                     ("projection", "projection")])
@pytest.mark.parametrize("reg", ["l2", "kl"])
def test_packaged_plan_decides_the_cards_f32_queries(kind, op, reg):
  """An f32 query on the card takes the packaged plan's first matching
  rule; where no rule matches (a shapeless query and its shape-bound
  rules, a minimax cap) the built-in plan answers."""
  packaged = plan_mod.default_plan()
  for shape in PACKAGED_SHAPES:
    rule = packaged.decide(kind, op, reg, platform="cuda", dtype="float32",
                           shape=shape)
    backend, source, _ = plan_mod.resolve_via_plans(
        kind, op, reg, platform="cuda", dtype="float32", shape=shape)
    if rule is None:
      assert source == "builtin", shape
    else:
      assert (backend, source) == (rule.backend, "default_plan"), shape
  # D.resolve reads the plan through dispatch's memo.
  if kind == "forward":
    want = plan_mod.decide(kind, op, reg, platform="cuda", dtype="float32",
                           shape=(128, 1000))[0]
    assert D.resolve(op, reg, None, GPU, dtype="float32",
                     shape=(128, 1000)) == want


def test_packaged_plan_provenance_and_breakpoints(packaged_plan, tmp_path):
  """The packaged plan names itself in artifacts' meta; its n-edges join
  the chain's breakpoints, and a plan installed in its place is read."""
  packaged = plan_mod.default_plan()
  assert plan_mod.plan_provenance() == {
      "plan_name": packaged.name, "plan_hash": packaged.plan_hash(),
      "plan_source": "default_plan"}
  assert plan_mod.shape_breakpoints() == plan_mod.shape_breakpoints(packaged)
  edges = {e for r in packaged.rules
           for e in (r.max_n, None if r.min_n is None else r.min_n - 1)
           if e is not None and e >= 1}
  assert set(plan_mod.shape_breakpoints()) == edges
  other = plan_mod.ExecutionPlan(name="edged", rules=(
      plan_mod.PlanRule("forward", "scan", platform="cuda", max_n=300,
                        evidence=("x",)),))
  other.save(str(tmp_path / "plan.json"))
  packaged_plan(tmp_path / "plan.json")
  assert plan_mod.default_plan() == other
  assert plan_mod.shape_breakpoints() == (300,)
  assert D.resolve("isotonic", "l2", None, GPU, dtype="float32",
                   shape=(8, 300)) == "scan"
  packaged_plan(None)
  assert plan_mod.default_plan() is None
  assert D.resolve("isotonic", "l2", None, GPU, dtype="float32",
                   shape=(8, 300)) == "cuda"


def test_f64_on_the_card_resolves_to_scan_through_dispatch():
  """F2: the f64 rule comes before the cuda rule; dispatch names the dtype
  as plans spell it."""
  assert D.dtype_name(torch.float64) == "float64"
  for reg in ("l2", "kl"):
    assert D.resolve("isotonic", reg, None, GPU, dtype="float64",
                     shape=(4, 9)) == "scan"
    assert D.resolve("isotonic", reg, None, GPU, dtype="float32",
                     shape=(4, 9)) == "cuda"


# ---------------------------------------------------------------------------
# Serialization: the reference's files and hashes.
# ---------------------------------------------------------------------------


def test_reference_default_plan_parses_to_the_same_rules_and_hash(
    no_packaged_plan):
  text = REFERENCE_PLAN.read_text()
  got, want = plan_mod.ExecutionPlan.from_json(text), jplan.load_plan(
      str(REFERENCE_PLAN))
  assert got.plan_hash() == want.plan_hash()
  assert got.name == want.name and got.meta == want.meta
  assert [r.to_dict() for r in got.rules] == [r.to_dict() for r in
                                              want.rules]
  assert json.loads(got.to_json()) == json.loads(want.to_json())
  assert plan_mod.load_plan(str(REFERENCE_PLAN)) == got


def test_plan_round_trips_and_hashes_as_the_reference(tmp_path):
  rules = (("forward", "minimax", dict(max_n=64, max_elems=16_000_000,
                                       evidence=("a/b",))),
           ("forward", "scan", dict(op="isotonic", platform="cuda",
                                    dtype="float64", min_rows=2)),
           ("backward", "segscan", {}),
           ("projection", "fused", dict(op="projection")))
  got = plan_mod.ExecutionPlan(
      name="mine", rules=tuple(plan_mod.PlanRule(k, b, **kw)
                               for k, b, kw in rules), meta={"x": 1})
  want = jplan.ExecutionPlan(
      name="mine", rules=tuple(jplan.PlanRule(k, b, **kw)
                               for k, b, kw in rules), meta={"x": 1})
  assert got.to_json() == want.to_json()
  assert got.plan_hash() == want.plan_hash()
  path = tmp_path / "plan.json"
  got.save(str(path))
  back = plan_mod.load_plan(str(path))
  assert back == got and back.plan_hash() == got.plan_hash()
  assert jplan.load_plan(str(path)).plan_hash() == got.plan_hash()
  # meta is provenance: it changes neither equality nor the hash.
  other = plan_mod.ExecutionPlan(name="mine", rules=got.rules, meta={})
  assert other == got and other.plan_hash() == got.plan_hash()
  renamed = plan_mod.ExecutionPlan(name="other", rules=got.rules)
  assert renamed.plan_hash() != got.plan_hash()


def _mutations():
  base = json.loads(REFERENCE_PLAN.read_text())
  cases = {}

  def case(name, fn):
    d = copy.deepcopy(base)
    fn(d)
    cases[name] = d

  case("schema", lambda d: d.update(schema="repro.plan/v2"))
  case("no-schema", lambda d: d.pop("schema"))
  case("plan-field", lambda d: d.update(extra=1))
  case("rule-field", lambda d: d["rules"][0].update(speed="fast"))
  case("rule-kind", lambda d: d["rules"][0].update(kind="sideways"))
  case("rule-backend", lambda d: d["rules"][0].pop("backend"))
  case("evidence", lambda d: d["rules"][0].update(evidence=[1, 2]))
  case("rules-type", lambda d: d.update(rules={}))
  case("meta-type", lambda d: d.update(meta=[]))
  return cases


@pytest.mark.parametrize("name", sorted(_mutations()))
def test_malformed_plans_are_refused_by_both(name):
  text = json.dumps(_mutations()[name])
  with pytest.raises(ValueError):
    jplan.ExecutionPlan.from_json(text)
  with pytest.raises(ValueError):
    plan_mod.ExecutionPlan.from_json(text)


def test_invalid_json_is_refused():
  with pytest.raises(ValueError, match="not valid JSON"):
    plan_mod.ExecutionPlan.from_json("{")


# ---------------------------------------------------------------------------
# Decisions: the same plan decides the same way in both packages.
# ---------------------------------------------------------------------------


def test_decisions_breakpoints_and_grid_match_the_reference():
  text = REFERENCE_PLAN.read_text()
  got = plan_mod.ExecutionPlan.from_json(text)
  want = jplan.ExecutionPlan.from_json(text)
  shapes = [(1, 50), (8, 100), (64, 321), (4, 4096), (256, 10000),
            (1, 2**20)]
  for kind in ("forward", "backward", "projection"):
    for reg in ("l2", "kl"):
      op = "projection" if kind == "projection" else "isotonic"
      for shape in shapes + [None]:
        a = got.decide(kind, op, reg, platform="cpu", dtype="float32",
                       shape=shape)
        b = want.decide(kind, op, reg, platform="cpu", dtype="float32",
                        shape=shape)
        assert (a and a.to_dict()) == (b and b.to_dict())
  # The reference's chain adds its built-in plan's minimax edge (64); the
  # port's built-in plan has no size rule.
  edges = plan_mod.shape_breakpoints(got)
  assert edges and set(jplan.shape_breakpoints(want)) - set(edges) <= {64}
  grid = plan_mod.resolve_grid("forward", ["isotonic"], ["l2", "kl"],
                               shapes, platform="cpu", dtype="float32",
                               plan=got)
  jgrid = jplan.resolve_grid("forward", ["isotonic"], ["l2", "kl"], shapes,
                             platform="cpu", dtype="float32", plan=want)
  # Where the plan is silent the two built-in plans answer, and differ.
  plan_rows = [g for g in jgrid if g["source"] == "plan"]
  assert [g for g in grid if g["source"] == "plan"] == plan_rows
  assert metrics.counters("plan_decide") == {}   # enumeration, not dispatch


def test_shape_constrained_rules_never_match_shapeless_queries(
    no_packaged_plan):
  gated = plan_mod.ExecutionPlan(name="gated", rules=(
      plan_mod.PlanRule("forward", "minimax", max_n=64),
      plan_mod.PlanRule("forward", "scan"),
  ))
  with plan_mod.use_plan(gated):
    assert D.resolve("isotonic", "l2", None, CPU, shape=(4, 9)) == "minimax"
    assert D.resolve("isotonic", "l2", None, CPU, shape=(4, 65)) == "scan"
    assert D.resolve("isotonic", "l2", None, CPU, shape=None) == "scan"
  assert plan_mod.shape_breakpoints(gated) == (64,)


# ---------------------------------------------------------------------------
# The resolution chain: argument > environment > active > default > built-in.
# ---------------------------------------------------------------------------

_CHAIN_CASES = [
    # kind, env var, built-in on the CPU, active-plan, env and arg backends
    ("forward", D.ENV_VAR, "stack", "scan", "minimax", "stack"),
    ("backward", D.BWD_ENV_VAR, "segscan", "scatter", "segscan", "scatter"),
    ("projection", D.PROJECTION_ENV_VAR, "fused", "composed", "fused",
     "composed"),
]


def _resolve(kind, request=None, plan=None):
  if kind == "forward":
    return D.resolve("isotonic", "l2", request, CPU, shape=(4, 9), plan=plan)
  if kind == "backward":
    return D.resolve_backward("projection", "l2", request, CPU,
                              shape=(4, 9), plan=plan)
  return D.resolve_projection(request, "l2", CPU, shape=(4, 9), plan=plan)


@pytest.mark.parametrize(
    "kind,env_var,builtin,plan_backend,env_backend,arg_backend",
    _CHAIN_CASES, ids=[c[0] for c in _CHAIN_CASES])
def test_precedence_chain(monkeypatch, kind, env_var, builtin, plan_backend,
                          env_backend, arg_backend):
  assert _resolve(kind) == builtin
  with plan_mod.use_plan(_pin(kind, plan_backend)):
    assert _resolve(kind) == plan_backend
    monkeypatch.setenv(env_var, env_backend)
    assert _resolve(kind) == env_backend
    assert _resolve(kind, arg_backend) == arg_backend
  monkeypatch.setenv(env_var, "auto")
  assert _resolve(kind, "auto") == builtin
  # A per-call plan beats the active plan and the default.
  with plan_mod.use_plan(_pin(kind, builtin, "active")):
    assert _resolve(kind, plan=_pin(kind, plan_backend)) == plan_backend
  # The packaged default plan sits between the active and built-in plans.
  try:
    plan_mod._default_cache[:] = [_pin(kind, plan_backend, "packaged")]
    plan_mod._changed()
    assert _resolve(kind) == plan_backend
    with plan_mod.use_plan(_pin(kind, builtin, "active")):
      assert _resolve(kind) == builtin
  finally:
    plan_mod.invalidate_default_plan_cache()
  assert _resolve(kind) == builtin


def test_unknown_environment_values_raise(monkeypatch):
  monkeypatch.setenv(D.BWD_ENV_VAR, "fast")
  with pytest.raises(ValueError, match=D.BWD_ENV_VAR):
    D.resolve_backward("isotonic", "l2", None, CPU)
  assert D.resolve_backward("isotonic", "l2", "scatter", CPU) == "scatter"
  with pytest.raises(ValueError, match="no backward backend"):
    D.resolve_backward("isotonic", "l2", "packed", CPU)
  # The reference's names are not the port's: REPRO_BACKEND is ignored.
  monkeypatch.setenv("REPRO_BACKEND", "lax")
  assert D.resolve("isotonic", "l2", None, CPU) == "stack"


# ---------------------------------------------------------------------------
# The memo of decisions and the counters.
# ---------------------------------------------------------------------------


def test_memo_is_dropped_when_the_active_plan_changes():
  assert D.resolve("isotonic", "l2", None, CPU, shape=(4, 9)) == "stack"
  assert len(D._MEMO) == 1
  assert D.resolve("isotonic", "l2", None, CPU, shape=(4, 9)) == "stack"
  assert len(D._MEMO) == 1                       # served from the memo
  plan_mod.set_active_plan(_pin("forward", "minimax"))
  assert len(D._MEMO) == 0
  assert D.resolve("isotonic", "l2", None, CPU, shape=(4, 9)) == "minimax"
  plan_mod.set_active_plan(None)
  assert D.resolve("isotonic", "l2", None, CPU, shape=(4, 9)) == "stack"


def test_counters_count_every_call_under_the_reference_names(monkeypatch):
  for _ in range(3):
    D.resolve("isotonic", "l2", None, CPU, shape=(4, 9))
  D.resolve("isotonic", "l2", "scan", CPU, shape=(4, 9))
  monkeypatch.setenv(D.BWD_ENV_VAR, "scatter")
  D.resolve_backward("isotonic", "kl", None, CPU)
  D.resolve_projection(None, "l2", CPU)
  c = metrics.counters()
  assert c["dispatch_resolve{backend=stack,op=isotonic,regularization=l2,"
           "source=builtin}"] == 3
  assert c["dispatch_resolve{backend=scan,op=isotonic,regularization=l2,"
           "source=arg}"] == 1
  assert c["plan_decide{backend=stack,kind=forward,plan=builtin,"
           "source=builtin}"] == 3
  assert c["dispatch_bwd_resolve{backend=scatter,op=isotonic,"
           "regularization=kl,source=env}"] == 1
  assert c["projection_resolve{backend=fused,op=projection,"
           "regularization=l2,source=builtin}"] == 1
  assert c["plan_decide{backend=fused,kind=projection,plan=builtin,"
           "source=builtin}"] == 1


# ---------------------------------------------------------------------------
# Plans govern real calls, forward and backward.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reg", ["l2", "kl"])
def test_per_call_plan_pins_forward_and_backward(reg):
  """``plan=`` on the projection governs the forward backend and, through
  the saved context, the backward run after the call returned; values and
  gradients equal the unpinned call's within the contract."""
  x = rng.normal(size=(3, 9))
  w = rng.normal(size=(9,))
  plan = plan_mod.ExecutionPlan(name="p", rules=(
      plan_mod.PlanRule("forward", "scan"),
      plan_mod.PlanRule("backward", "scatter"),
  ))
  outs = []
  for p in (plan, None):
    xt = as_torch(x, grad=True)
    out = projection_permutahedron(xt, as_torch(w), reg, plan=p)
    (g,) = torch.autograd.grad(out.sum(), xt)
    outs.append((out.detach(), g))
  assert_close(outs[0][0], outs[1][0], x, w)
  assert_close(outs[0][1], outs[1][1], x, w)
  c = metrics.counters()
  assert c["plan_decide{backend=scan,kind=forward,plan=p,source=plan}"] == 1
  assert c["plan_decide{backend=scatter,kind=backward,plan=p,"
           "source=plan}"] == 1
  assert c["plan_decide{backend=segscan,kind=backward,plan=builtin,"
           "source=builtin}"] == 1


def test_use_plan_and_the_plan_flag_route_the_same(tmp_path):
  plan = plan_mod.ExecutionPlan(name="flag", rules=(
      plan_mod.PlanRule("forward", "minimax"),))
  path = tmp_path / "plan.json"
  plan.save(str(path))
  x = as_torch(rng.normal(size=(2, 7)))
  with plan_mod.use_plan(plan):
    a = soft_rank(x, 0.5)
  snap = metrics.counters("plan_decide")
  metrics.reset()
  plan_mod.set_active_plan(plan_mod.load_plan(str(path)))
  b = soft_rank(x, 0.5)
  assert torch.equal(a, b)
  assert metrics.counters("plan_decide") == snap
  assert "plan_decide{backend=minimax,kind=forward,plan=flag," \
         "source=plan}" in snap


def test_plan_provenance_names_the_governing_plan(no_packaged_plan):
  prov = plan_mod.plan_provenance()
  assert prov == {"plan_name": "builtin",
                  "plan_hash": plan_mod.builtin_plan().plan_hash(),
                  "plan_source": "builtin"}
  p = _pin("forward", "scan", "mine")
  with plan_mod.use_plan(p):
    assert plan_mod.plan_provenance()["plan_source"] == "plan"
  assert plan_mod.plan_provenance(p)["plan_hash"] == p.plan_hash()


# ---------------------------------------------------------------------------
# The reference's selection shims, over the port's plans.
# ---------------------------------------------------------------------------


def test_set_default_backend_puts_a_rule_on_the_plan_and_auto_removes_it():
  """``set_default_backend("scan")`` prepends an unconditional forward rule
  to the active plan, which ``soft_rank`` on the CPU then resolves (the
  plan decides, by the ``dispatch_resolve`` counter's source); ``"auto"``
  removes it and the built-in plan's ``stack`` decides again.  The
  reference's shim does the same on its plan."""
  D.set_default_backend("scan")
  assert D.get_default_backend() == "scan"
  active = plan_mod.get_active_plan()
  assert active.rules[0] == plan_mod.PlanRule("forward", "scan")
  assert D.resolve_backend("isotonic", "l2") == "scan"
  x = as_torch(rng.normal(size=(3, 9)))
  metrics.reset()
  got = soft_rank(x, 0.5)
  assert metrics.counter_value("dispatch_resolve", op="isotonic",
                               regularization="l2", backend="scan",
                               source="plan") == 1
  D.set_default_backend("auto")
  assert D.get_default_backend() == "auto"
  assert not plan_mod.get_active_plan().rules
  assert D.resolve_backend("isotonic", "l2") == "stack"
  assert_close(got, soft_rank(x, 0.5), x)
  from repro.kernels import dispatch as jD
  jplan.set_active_plan(None)
  try:
    jD.set_default_backend("scan")
    assert jplan.get_active_plan().rules[0].to_dict() == {
        "kind": "forward", "backend": "scan"}
    assert jD.get_default_backend() == "scan"
    jD.set_default_backend("auto")
    assert not jplan.get_active_plan().rules
  finally:
    jplan.set_active_plan(None)


def test_set_default_impl_and_use_impl_are_the_core_aliases():
  from repro_torch import core
  core.set_default_impl("minimax")
  assert D.get_default_backend() == "minimax"
  core.set_default_impl("auto")
  with core.use_impl("scan"):
    assert D.resolve("isotonic", "kl") == "scan"
    assert D.get_default_backend() == "scan"
  assert D.get_default_backend() == "auto"
  assert D.resolve("isotonic", "kl") == "stack"
  assert core.use_plan is plan_mod.use_plan
  assert core.ExecutionPlan is plan_mod.ExecutionPlan
  assert core.PlanRule is plan_mod.PlanRule
  assert core.load_plan is plan_mod.load_plan
  assert core.set_active_plan is plan_mod.set_active_plan


def test_use_backward_is_scoped_and_set_default_backward_persists():
  base = _pin("forward", "stack", "base")
  plan_mod.set_active_plan(base)
  with D.use_backward("segscan"):
    assert D.get_default_backward() == "segscan"
    assert D.resolve_backward("isotonic", "l2", device=GPU) == "segscan"
    assert plan_mod.get_active_plan().rules[1:] == base.rules
  assert plan_mod.get_active_plan() is base
  assert D.get_default_backward() == "auto"
  assert D.resolve_backward("isotonic", "l2", device=GPU) == "scatter"
  D.set_default_backward("scatter")
  assert D.resolve_backward("isotonic", "l2") == "scatter"
  assert plan_mod.get_active_plan().name == "base+backward=scatter"
  D.set_default_backward("auto")
  assert plan_mod.get_active_plan().rules == base.rules


@pytest.mark.parametrize("shim, name", [
    (D.set_default_backend, "lax"), (D.set_default_backend, "pallas"),
    (D.use_backend, "fused"), (D.set_default_backward, "scan"),
    (D.use_backward, "cuda")])
def test_selection_shims_refuse_unknown_names(shim, name):
  with pytest.raises(ValueError, match="must be one of"):
    if shim in (D.use_backend, D.use_backward):
      with shim(name):
        pass
    else:
      shim(name)
  assert plan_mod.get_active_plan() is None


def test_resolve_backend_takes_the_platform_by_name():
  assert D.resolve_backend("isotonic", "l2", platform="cuda",
                           dtype="float32") == "cuda"
  assert D.resolve_backend("isotonic", "l2", platform="cuda",
                           dtype="float64") == "scan"
  assert D.resolve_backend("isotonic", "kl", "minimax",
                           platform="cuda") == "minimax"
