"""The port's backend gate (``repro_torch.tools.check_backends``): each
check passes on the committed README, packaged plan and its evidence,
and fails on a crafted bad case of each kind it guards."""

from __future__ import annotations

import copy
import json
import re

import pytest

pytest.importorskip("torch")

from test_torch_common import ROOT  # noqa: E402

from repro_torch import plan as plan_mod  # noqa: E402
from repro_torch.kernels import dispatch as D  # noqa: E402
from repro_torch.tools import autotune, check_backends as cb  # noqa: E402

PLAN = plan_mod.DEFAULT_PLAN_PATH
RUNTIME, PROJECTION = autotune.DEFAULT_BENCH, autotune.DEFAULT_BENCH_PROJECTION
BACKENDS = ("cuda", "stack", "scan", "minimax", "segscan", "scatter",
            "fused", "composed", "auto")


def _payload(path: str) -> dict:
  with open(path, encoding="utf-8") as f:
    return json.load(f)


def _write(tmp_path, name: str, payload) -> str:
  path = tmp_path / name
  path.write_text(json.dumps(payload))
  return str(path)


def _plan_with(tmp_path, *rules) -> str:
  plan = plan_mod.ExecutionPlan(name="crafted", rules=rules)
  path = tmp_path / "plan.json"
  plan.save(str(path))
  return str(path)


def _a_ran_row(backend: str = "cuda") -> str:
  return next(r["name"] for r in _payload(RUNTIME)["results"]
              if r["backend"] == backend and "skipped" not in r)


# ---------------------------------------------------------------------------
# Everything committed passes.
# ---------------------------------------------------------------------------


def test_every_check_passes_on_the_committed_files(capsys):
  assert cb.check_docs_coverage() == []
  assert cb.check_bench_artifact(RUNTIME) == []
  assert cb.check_projection_artifact(PROJECTION) == []
  assert cb.check_plan(PLAN, [RUNTIME, PROJECTION]) == []
  assert cb.main(["--bench", RUNTIME, "--bench-projection", PROJECTION,
                  "--plan", PLAN]) == 0
  out = capsys.readouterr()
  assert "0 problems" in out.out and out.err == ""


def test_the_plans_evidence_defaults_to_the_committed_sweeps():
  assert cb.main(["--plan", PLAN]) == 0


def test_the_port_section_is_what_check_1_reads():
  text = (ROOT / "README.md").read_text()
  section = cb.port_section(text)
  assert section.startswith(cb.PORT_SECTION)
  assert "\n## " not in section
  assert set(BACKENDS) <= set(cb._CODE_TOKEN_RE.findall(section))


# ---------------------------------------------------------------------------
# Check 1: docs.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_a_registered_backend_missing_from_the_readme_fails(tmp_path,
                                                            backend):
  text = (ROOT / "README.md").read_text()
  section = cb.port_section(text)
  stripped = re.sub(rf'`"?{backend}"?`', backend, section)
  readme = tmp_path / "README.md"
  readme.write_text(text.replace(section, stripped))
  problems = cb.check_docs_coverage(str(readme))
  assert len(problems) == 1 and repr(backend) in problems[0]
  assert "not documented" in problems[0]
  assert cb.main(["--readme", str(readme)]) == 1


def test_a_documented_backend_that_is_not_registered_fails(monkeypatch):
  for reg in ("l2", "kl"):
    monkeypatch.delitem(D._REGISTRY, ("isotonic", reg, "minimax"))
  problems = cb.check_docs_coverage()
  assert problems and all("'minimax'" in p for p in problems)
  assert any("not registered" in p for p in problems)


def test_a_readme_without_the_port_section_fails(tmp_path):
  readme = tmp_path / "README.md"
  readme.write_text("# Title\n\n`cuda` `stack`\n")
  assert "no '## PyTorch/CUDA port' section" in cb.check_docs_coverage(
      str(readme))[0]


# ---------------------------------------------------------------------------
# Check 2: the backend sweep covers every backend.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["cuda", "stack", "scan", "minimax"])
def test_a_backend_skipped_everywhere_fails(tmp_path, backend):
  payload = _payload(RUNTIME)
  for r in payload["results"]:
    if r["backend"] == backend:
      for k in [k for k in r if k.endswith("_us")]:
        del r[k]
      r["skipped"] = "crafted"
  problems = cb.check_bench_artifact(_write(tmp_path, "r.json", payload))
  assert len(problems) == 2 and all("only skipped rows" in p
                                    for p in problems)


def test_a_backend_with_no_rows_fails(tmp_path):
  payload = _payload(RUNTIME)
  payload["results"] = [r for r in payload["results"]
                        if not (r["backend"] == "scan"
                                and r["regularization"] == "kl")]
  problems = cb.check_bench_artifact(_write(tmp_path, "r.json", payload))
  assert problems == [f"{tmp_path / 'r.json'}: no results for "
                      "backend='scan' regularization='kl'"]
  assert cb.check_bench_artifact(str(tmp_path / "none.json")) == [
      f"{tmp_path / 'none.json'}: artifact not found"]


# ---------------------------------------------------------------------------
# Check 3: projection.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reg", ["l2", "kl"])
def test_fused_slower_than_composed_fails(tmp_path, reg):
  payload = _payload(PROJECTION)
  rows = {(r["backend"], r["regularization"], r["n"]): r
          for r in payload["results"]}
  n = max(r["n"] for r in payload["results"])
  rows[("fused", reg, n)]["e2e_fwd_bwd_us"] = (
      rows[("composed", reg, n)]["e2e_fwd_bwd_us"] * 1.01)
  path = _write(tmp_path, "p.json", payload)
  problems = cb.check_projection_artifact(path)
  assert len(problems) == 1 and "projection regression" in problems[0]
  assert f"reg={reg!r} n={n}" in problems[0]
  assert cb.main(["--bench-projection", path]) == 1


def test_a_projection_path_that_did_not_run_fails(tmp_path):
  payload = _payload(PROJECTION)
  payload["results"] = [r for r in payload["results"]
                        if r["backend"] != "composed"]
  problems = cb.check_projection_artifact(
      _write(tmp_path, "p.json", payload))
  assert len(problems) == 2
  assert all("no ran results for projection path 'composed'" in p
             for p in problems)


# ---------------------------------------------------------------------------
# Check 5: the plan's evidence.
# ---------------------------------------------------------------------------


def _rule(backend="cuda", kind="forward", **kw):
  kw.setdefault("evidence", (_a_ran_row(),))
  return plan_mod.PlanRule(kind, backend, platform="cuda", dtype="float32",
                           **kw)


def test_an_evidence_name_with_no_row_fails(tmp_path):
  plan = _plan_with(tmp_path, _rule(evidence=(
      _a_ran_row(), "backend_sweep/l2/cuda/n=5/b=5")))
  problems = cb.check_plan(plan, [RUNTIME, PROJECTION])
  assert len(problems) == 1 and "n=5/b=5" in problems[0]
  assert "is in none of" in problems[0]
  assert cb.main(["--plan", plan]) == 1


def test_evidence_that_was_skipped_fails(tmp_path):
  payload = _payload(RUNTIME)
  cited = _a_ran_row("scan")
  for r in payload["results"]:
    if r["name"] == cited:
      for k in [k for k in r if k.endswith("_us")]:
        del r[k]
      r["skipped"] = "crafted"
  runtime = _write(tmp_path, "r.json", payload)
  plan = _plan_with(tmp_path, _rule("scan", evidence=(cited,)))
  problems = cb.check_plan(plan, [runtime, PROJECTION])
  assert len(problems) == 1 and "no finite timing" in problems[0]
  assert cb.check_plan(plan, [RUNTIME, PROJECTION]) == []


@pytest.mark.parametrize("kind,backend", [
    ("forward", "lax"), ("forward", "scatter"), ("backward", "cuda"),
    ("projection", "scan")])
def test_a_backend_not_registered_for_its_kind_fails(tmp_path, kind,
                                                     backend):
  plan = _plan_with(tmp_path, _rule(backend, kind))
  problems = cb.check_plan(plan, [RUNTIME, PROJECTION])
  assert len(problems) == 1 and "not registered for kind" in problems[0]


def test_minimax_without_its_cap_fails(tmp_path):
  row = _a_ran_row("minimax")
  capped = _plan_with(tmp_path, _rule("minimax", evidence=(row,),
                                      max_elems=autotune.MINIMAX_MAX_ELEMS))
  assert cb.check_plan(capped, [RUNTIME, PROJECTION]) == []
  plan = _plan_with(tmp_path, _rule("minimax", evidence=(row,)))
  problems = cb.check_plan(plan, [RUNTIME, PROJECTION])
  assert len(problems) == 1 and "'max_elems'" in problems[0]


def test_a_rule_without_evidence_or_a_bad_file_fails(tmp_path):
  plan = _plan_with(tmp_path, _rule(evidence=()))
  problems = cb.check_plan(plan, [RUNTIME, PROJECTION])
  assert len(problems) == 1 and "no 'evidence'" in problems[0]
  bad = copy.deepcopy(_payload(PLAN))
  bad["rules"][0]["bogus"] = 1
  problems = cb.check_plan(_write(tmp_path, "bad.json", bad),
                           [RUNTIME, PROJECTION])
  assert len(problems) == 1 and "unknown field" in problems[0]
  problems = cb.check_plan(PLAN, [RUNTIME, str(tmp_path / "gone.json")])
  assert any("gone.json not found" in p for p in problems)
