"""The port's plan derivation (``repro_torch.tools.autotune``) against the
reference's (``tools/autotune.py``, loaded by path and run unchanged), and
the port's speed sweeps (``repro_torch.tools.sweeps``) at a tiny size on
the CPU.

Plans are data, so the comparisons are exact: the same artifacts give the
same rules in the same order.  The reference's committed artifacts
(``BENCH_runtime.json``, ``BENCH_projection.json``) are read only as
inputs to both derivations.
"""

from __future__ import annotations

import importlib.util
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_common import ROOT, packaged_plan  # noqa: E402,F401

from repro import obs as jobs  # noqa: E402
from repro_torch import plan as plan_mod  # noqa: E402
from repro_torch.obs import artifacts  # noqa: E402
from repro_torch.tools import autotune, sweeps  # noqa: E402

REFERENCE_PLAN = ROOT / "src" / "repro" / "plan" / "default_plan.json"
BACKENDS = ("cuda", "minimax", "pallas", "scan", "stack")


@pytest.fixture(scope="module")
def reference_autotune():
  """The reference's ``tools/autotune.py`` as a module, unchanged."""
  spec = importlib.util.spec_from_file_location(
      "reference_autotune", ROOT / "tools" / "autotune.py")
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _load(name: str) -> dict:
  return json.loads((ROOT / name).read_text())


def _dicts(plan) -> list[dict]:
  return [r.to_dict() for r in plan.rules]


def test_reference_artifacts_give_the_reference_plan(reference_autotune):
  """Fed the reference's committed sweeps, the port derives the
  reference's committed plan rule for rule, as the reference's own
  ``build_plan`` does."""
  runtime, projection = _load("BENCH_runtime.json"), _load(
      "BENCH_projection.json")
  got = autotune.build_plan(runtime, projection)
  want = reference_autotune.build_plan(runtime, projection)
  committed = json.loads(REFERENCE_PLAN.read_text())
  assert _dicts(got) == _dicts(want) == committed["rules"]
  assert len(got.rules) == 11
  assert got.name == want.name == committed["name"] == "autotuned-cpu"
  assert got.meta["cells"] == committed["meta"]["cells"]
  assert got.meta["derived_from"] == committed["meta"]["derived_from"]


def _synthetic(seed: int, meta_extra: dict) -> tuple[dict, dict]:
  """Sweep payloads of the reference's grid with random timings: minimax
  fast at small n, pallas rows (interpreter timings), skipped rows that
  carry a timing that would win."""
  rng = np.random.default_rng(seed)
  results = []
  for n in (100, 1024, 4096, 10000):
    for b in (1, 32, 256):
      for backend in BACKENDS:
        for reg in ("l2", "kl"):
          rec = {"name": f"backend_sweep/{reg}/{backend}/n={n}/b={b}",
                 "op": "soft_rank", "regularization": reg,
                 "backend": backend, "n": n, "batch": b}
          if backend == "minimax" and b * n * n > 64e6:
            rec["skipped"] = "minimax needs batch*n^2"
          elif backend == "stack" and n >= 4096:
            rec["skipped"] = "past the budget"
          if "skipped" in rec:
            rec["fwd_bwd_us"] = 1e-3
          else:
            scale = {"minimax": 0.2 * n / 100, "pallas": 0.01}.get(
                backend, 1.0)
            rec["fwd_bwd_us"] = float(rng.lognormal(0, 0.5) * scale * n)
            rec["fwd_us"] = rec["fwd_bwd_us"] / 2
          results.append(rec)
  proj = []
  for n in (1024, 4096):
    for reg in ("l2", "kl"):
      for path in ("composed", "fused"):
        proj.append({"name": f"projection/{reg}/{path}/n={n}/b=8",
                     "regularization": reg, "backend": path, "n": n,
                     "batch": 8, "e2e_fwd_bwd_us":
                         float(rng.lognormal(0, 0.5) * n)})
      proj.append({"name": f"projection/{reg}/speedup/n={n}/b=8",
                   "regularization": reg, "backend": "fused_vs_composed",
                   "n": n, "batch": 8, "speedup_x": 1.0})
  meta = {"platform": "gpu", "git_sha": f"sha{seed}", **meta_extra}
  return ({"meta": meta, "results": results},
          {"meta": {"platform": "gpu", "git_sha": "p"}, "results": proj})


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("meta_extra", [
    {"dtype": "float32"}, {"dtype": "float32", "backward": "scatter"}])
def test_synthetic_artifacts_give_the_references_rules_on_the_card(
    reference_autotune, seed, meta_extra):
  """The port's rules are the reference's with ``platform="cuda"`` (the
  artifact's "gpu") and the artifact's dtype; the backward rule pins the
  artifact's backward; a minimax winner carries its cap; skipped and
  pallas rows never win."""
  runtime, projection = _synthetic(seed, meta_extra)
  got = autotune.build_plan(runtime, projection)
  want = reference_autotune.build_plan(runtime, projection)
  backward = meta_extra.get("backward", "segscan")
  expected = []
  for rule in _dicts(want):
    rule.update(platform="cuda", dtype="float32")
    if rule["kind"] == "backward":
      rule["backend"] = backward
    expected.append(rule)
  assert _dicts(got) == expected
  assert got.name == "autotuned-cuda"
  skipped = {r["name"] for r in runtime["results"] if "skipped" in r}
  winners = [r for r in got.rules if r.kind == "forward"]
  assert any(r.backend == "minimax" for r in winners)
  for rule in got.rules:
    assert rule.backend != "pallas"
    assert not skipped & set(rule.evidence)
    assert (rule.max_elems == autotune.MINIMAX_MAX_ELEMS) == (
        rule.backend == "minimax")
  # The derived plan routes an f64 solve on the card to the built-in scan.
  assert got.decide("forward", "isotonic", "l2", platform="cuda",
                    dtype="float64", shape=(8, 100)) is None
  assert got.decide("forward", "isotonic", "l2", platform="cpu",
                    dtype="float32", shape=(8, 100)) is None


def test_an_artifact_without_dtype_gives_unkeyed_rules():
  runtime, projection = _synthetic(0, {})
  plan = autotune.build_plan(runtime, projection)
  assert {r.dtype for r in plan.rules} == {"*"}
  assert {r.platform for r in plan.rules} == {"cuda"}


# ---------------------------------------------------------------------------
# The sweeps, tiny, on the CPU.
# ---------------------------------------------------------------------------

TINY_NS, TINY_BATCHES = (16, 64), (1, 2)
RAN_COLUMNS = {"fwd_us", "fwd_bwd_us", "iso_fwd_us", "e2e_fwd_us",
               "solver_share"}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
  out = tmp_path_factory.mktemp("sweeps")
  runtime = sweeps.run_backend_sweep(
      out_path=str(out / "runtime.json"), device="cpu", ns=TINY_NS,
      batches=TINY_BATCHES)
  projection = sweeps.run_projection(
      out_path=str(out / "projection.json"), device="cpu", ns=(64,))
  return out, runtime, projection


def test_tiny_backend_sweep_writes_the_references_rows(tiny):
  out, runtime, _ = tiny
  path = str(out / "runtime.json")
  assert artifacts.validate_file(path) == []
  assert jobs.artifacts.validate_file(path) == []
  names = [r["name"] for r in runtime["results"]]
  assert names == [f"backend_sweep/{reg}/{b}/n={n}/b={batch}"
                   for n in TINY_NS for batch in TINY_BATCHES
                   for b in ("cuda", "minimax", "scan", "stack")
                   for reg in ("l2", "kl")]
  for r in runtime["results"]:
    assert r["op"] == "soft_rank"
    if r["backend"] == "cuda":
      assert "no card" in r["skipped"] and not RAN_COLUMNS & set(r)
    else:
      assert RAN_COLUMNS <= set(r), r
      assert r["e2e_fwd_us"] == r["fwd_us"]
      assert r["solver_share"] == round(r["iso_fwd_us"] / r["fwd_us"], 4)
  meta = runtime["meta"]
  assert (meta["platform"], meta["dtype"], meta["card"]) == (
      "cpu", "float32", "cpu")
  assert meta["backward"] == "segscan" and meta["auto_resolves_to"] == "stack"
  assert meta["plan_source"] in ("builtin", "default_plan")


def test_tiny_projection_sweep_writes_both_paths_and_the_speedup(tiny):
  out, _, projection = tiny
  assert artifacts.validate_file(str(out / "projection.json")) == []
  rows = {r["name"]: r for r in projection["results"]}
  for reg in ("l2", "kl"):
    for path in ("composed", "fused"):
      r = rows[f"projection/{reg}/{path}/n=64/b=8"]
      assert r["impl"] == "stack" and r["e2e_fwd_bwd_us"] > 0
    s = rows[f"projection/{reg}/speedup/n=64/b=8"]
    assert s["speedup_x"] == round(
        s["composed_fwd_bwd_us"] / s["fused_fwd_bwd_us"], 3)
  assert projection["meta"]["impl"] == "stack"
  assert projection["meta"]["default_path"] == "fused"


def test_tiny_sweeps_derive_a_cpu_plan(tiny):
  _, runtime, projection = tiny
  plan = autotune.build_plan(runtime, projection)
  assert {(r.platform, r.dtype) for r in plan.rules} == {("cpu", "float32")}
  assert {r.kind for r in plan.rules} == {"forward", "backward",
                                          "projection"}
  assert all(r.backend != "cuda" for r in plan.rules)
  cells = {(r["regularization"], r["n"], r["batch"])
           for r in runtime["results"] if "skipped" not in r}
  assert plan.meta["cells"]["runtime"] == len(cells) == 8


def test_the_caps_record_their_reasons():
  cpu = torch.device("cpu")
  assert "batch*n^2" in sweeps._feasibility("minimax", 8192, 1, cpu)
  assert sweeps._feasibility("minimax", 4096, 1, cpu) == ""
  assert "no card" in sweeps._feasibility("cuda", 16, 1, cpu)
  assert sweeps._feasibility("stack", 10**6, 256, cpu) == ""
  theta = torch.zeros(1, 8)
  reason = sweeps._over_budget(lambda t: t + 1, theta, 12, 0.0)
  assert "past the 0 s budget" in reason
  assert sweeps._over_budget(lambda t: t + 1, theta, 12, 60.0) == ""


def test_stack_rows_past_the_budget_are_skipped(tmp_path):
  payload = sweeps.run_backend_sweep(
      out_path=str(tmp_path / "r.json"), device="cpu", ns=(16,),
      batches=(1,), stack_budget_s=0.0)
  stack = [r for r in payload["results"] if r["backend"] == "stack"]
  assert len(stack) == 2
  assert all("budget" in r["skipped"] for r in stack)
  assert payload["meta"]["stack_budget_s"] == 0.0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_the_sweeps_and_autotune_refuse_without_a_card(tmp_path):
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    sweeps.run_backend_sweep(out_path=str(tmp_path / "r.json"))
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    sweeps.run_projection(out_path=str(tmp_path / "p.json"))
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    autotune.main(["--smoke", "--bench", str(tmp_path / "r.json"),
                   "--bench-projection", str(tmp_path / "p.json"),
                   "--out", str(tmp_path / "plan.json")])
  assert not list(tmp_path.iterdir())


def test_autotune_main_derives_the_packaged_plan_from_its_evidence(capsys):
  """Without ``--run`` nothing runs: the committed evidence gives the
  committed plan."""
  assert autotune.main(["--dry-run"]) == 0
  printed = plan_mod.ExecutionPlan.from_json(capsys.readouterr().out)
  packaged = plan_mod.load_plan(plan_mod.DEFAULT_PLAN_PATH)
  assert printed == packaged
  assert printed.plan_hash() == packaged.plan_hash()
  assert printed.meta == packaged.meta


def test_autotune_main_writes_a_plan_and_drops_the_cache(packaged_plan,
                                                         tmp_path, tiny):
  out, _, _ = tiny
  plan_path = tmp_path / "plan.json"
  packaged_plan(plan_path)              # absent until autotune writes it
  assert plan_mod.default_plan() is None
  assert autotune.main(["--bench", str(out / "runtime.json"),
                        "--bench-projection", str(out / "projection.json"),
                        "--out", str(plan_path)]) == 0
  assert plan_mod.default_plan() == plan_mod.load_plan(str(plan_path))
  assert plan_mod.default_plan().name == "autotuned-cpu"
