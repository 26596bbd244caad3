"""Backend-registry gate: docs coverage, sweep coverage, the projection
guard and the packaged plan's evidence.

  PYTHONPATH=src python -m repro_torch.tools.check_backends \\
      [--bench RUNTIME.json] [--bench-projection PROJECTION.json] \\
      [--plan PLAN.json [--plan-bench ...] [--plan-bench-projection ...]]

Counterpart of the reference's ``tools/check_backends.py``, checks 1, 2, 3
and 5 (``:66-287``), against the port's registries
(``repro_torch.kernels.dispatch``).  The first always runs, the others
with their flag:

1. **Docs coverage.**  Every backend registered in the port's dispatch
   (the isotonic forward and backward registries, the projection paths,
   and the ``auto`` alias) appears as an inline-code token in the README's
   port section (``## PyTorch/CUDA port``), and the section names no
   backend of ``BACKENDS`` / ``BWD_BACKENDS`` / ``PROJECTION_PATHS`` that
   is not registered.  The reference's second document,
   ``docs/ARCHITECTURE.md``, is the reference's own and is not read.
2. **Sweep completeness** (``--bench``).  Every concrete forward backend,
   in both regularizations, has at least one row that ran (a finite
   ``*_us`` timing); a backend skipped everywhere fails.
3. **Projection** (``--bench-projection``).  A finite row for each
   projection path and regularization, and in every (n, batch) cell where
   both ran, fused's ``e2e_fwd_bwd_us`` not above composed's: the fused
   pipeline slower than the chain it replaces is a regression.
5. **Plan evidence** (``--plan``).  The plan loads strictly (schema, no
   unknown field); every rule names a backend registered for its kind; a
   ``minimax`` rule carries its ``max_elems`` cap; every rule cites
   evidence, and every row it cites exists with a finite timing in
   ``--plan-bench`` / ``--plan-bench-projection`` (default: the committed
   evidence beside the packaged plan).

The reference's check 4 (the serving artifact) waits for the port's
serving benchmark.  Exit status 0 when clean, 1 otherwise (each problem
on stderr).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys

from repro_torch import plan as plan_mod
from repro_torch.tools.autotune import (DEFAULT_BENCH,
                                        DEFAULT_BENCH_PROJECTION)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
README = os.path.join(REPO_ROOT, "README.md")
PORT_SECTION = "## PyTorch/CUDA port"

_CODE_TOKEN_RE = re.compile(r"`\"?([a-z_]+)\"?`")
REGS = ("l2", "kl")


def _registered() -> tuple[set[str], set[str], set[str]]:
  """(forward, backward, projection) backends registered in the port."""
  # Importing core.projection registers the projection paths.
  import repro_torch.core.projection  # noqa: F401
  from repro_torch.kernels import dispatch as D
  fwd, bwd, proj = set(), set(), set()
  for reg in REGS:
    fwd |= set(D.registered_backends("isotonic", reg))
    bwd |= set(D.registered_backward_backends("isotonic", reg))
    proj |= set(D.registered_backends("projection", reg))
  return fwd, bwd, proj


def port_section(text: str) -> str:
  """The README's port section: from its heading to the next ``## ``."""
  lines = text.splitlines()
  for i, line in enumerate(lines):
    if line.startswith(PORT_SECTION):
      end = next((j for j in range(i + 1, len(lines))
                  if lines[j].startswith("## ")), len(lines))
      return "\n".join(lines[i:end])
  return ""


def check_docs_coverage(readme: str = README) -> list[str]:
  from repro_torch.kernels import dispatch as D
  try:
    with open(readme, encoding="utf-8") as f:
      section = port_section(f.read())
  except OSError as e:
    return [f"{readme}: cannot read: {e}"]
  if not section:
    return [f"{readme}: no {PORT_SECTION!r} section"]
  problems = []
  fwd, bwd, proj = _registered()
  want = fwd | bwd | proj | {"auto"}
  known = set(D.BACKENDS) | set(D.BWD_BACKENDS) | set(D.PROJECTION_PATHS)
  documented = set(_CODE_TOKEN_RE.findall(section))
  for backend in sorted(want - documented):
    problems.append(f"{readme}: registered backend {backend!r} is not "
                    f"documented in the port section (expected a "
                    f"`\"{backend}\"` or `{backend}` code token)")
  for backend in sorted(documented & (known - want)):
    problems.append(f"{readme}: the port section documents backend "
                    f"{backend!r}, which is not registered")
  return problems


def _finite_timing(rec: dict) -> bool:
  return any(k.endswith("_us") and isinstance(v, (int, float))
             and not isinstance(v, bool) and math.isfinite(v)
             for k, v in rec.items())


def _results(path: str) -> list[dict] | None:
  if not os.path.exists(path):
    return None
  with open(path, encoding="utf-8") as f:
    return json.load(f).get("results", [])


def check_bench_artifact(path: str) -> list[str]:
  results = _results(path)
  if results is None:
    return [f"{path}: artifact not found"]
  problems = []
  fwd, _, _ = _registered()
  for backend in sorted(fwd):
    for reg in REGS:
      rows = [r for r in results
              if r.get("backend") == backend
              and r.get("regularization") == reg]
      if not rows:
        problems.append(f"{path}: no results for backend={backend!r} "
                        f"regularization={reg!r}")
      elif not any(_finite_timing(r) for r in rows):
        problems.append(f"{path}: backend={backend!r} "
                        f"regularization={reg!r} has only skipped rows "
                        f"({rows[0].get('skipped', '?')!r}); at least one "
                        f"cell must run")
  return problems


def check_projection_artifact(path: str) -> list[str]:
  """Projection-path completeness + the fused-vs-composed guard."""
  results = _results(path)
  if results is None:
    return [f"{path}: artifact not found"]
  problems = []
  _, _, proj = _registered()
  for reg in REGS:
    for p in sorted(proj):
      if not any(r.get("backend") == p and r.get("regularization") == reg
                 and _finite_timing(r) for r in results):
        problems.append(f"{path}: no ran results for projection path "
                        f"{p!r} regularization={reg!r}")
    cells: dict[tuple, dict[str, dict]] = {}
    for r in results:
      if (r.get("regularization") == reg and _finite_timing(r)
          and r.get("backend") in ("fused", "composed")):
        cells.setdefault((r.get("n"), r.get("batch")),
                         {})[r["backend"]] = r
    for (n, batch), by_path in sorted(cells.items(), key=str):
      fused, composed = by_path.get("fused"), by_path.get("composed")
      if not (fused and composed):
        continue
      f_us = fused.get("e2e_fwd_bwd_us")
      c_us = composed.get("e2e_fwd_bwd_us")
      if not (_finite_timing({"f_us": f_us})
              and _finite_timing({"c_us": c_us})):
        problems.append(f"{path}: projection cell reg={reg!r} n={n} "
                        f"b={batch} is missing 'e2e_fwd_bwd_us'")
      elif f_us > c_us:
        problems.append(
            f"{path}: projection regression: fused e2e fwd+bwd "
            f"({f_us:.1f}us) slower than composed ({c_us:.1f}us) at "
            f"reg={reg!r} n={n} b={batch}")
  return problems


def _timed_rows(paths: list[str]) -> tuple[set[str], set[str]]:
  """(names with a finite timing, names of any row) over the artifacts."""
  timed, named = set(), set()
  for path in paths:
    for r in _results(path) or ():
      if isinstance(r, dict) and "name" in r:
        named.add(r["name"])
        if _finite_timing(r):
          timed.add(r["name"])
  return timed, named


def check_plan(plan_path: str, bench_paths: list[str]) -> list[str]:
  """The plan gate: strict load, registered backends, the minimax cap,
  every cited evidence row measured."""
  try:
    plan = plan_mod.load_plan(plan_path)
  except (OSError, ValueError) as e:
    return [f"{plan_path}: failed to load: {e}"]
  problems = [f"{plan_path}: evidence artifact {p} not found"
              for p in bench_paths if not os.path.exists(p)]
  fwd, bwd, proj = _registered()
  by_kind = {"forward": fwd, "backward": bwd, "projection": proj}
  timed, named = _timed_rows(bench_paths)
  for i, rule in enumerate(plan.rules):
    where = f"{plan_path}: rule #{i} ({rule.kind} -> {rule.backend!r})"
    if rule.backend not in by_kind[rule.kind]:
      problems.append(
          f"{where}: backend not registered for kind {rule.kind!r} "
          f"(have {sorted(by_kind[rule.kind])})")
    if rule.backend == "minimax" and rule.max_elems is None:
      problems.append(f"{where}: minimax rule without a 'max_elems' memory "
                      f"cap; the O(n^2) form must stay size-capped")
    if not rule.evidence:
      problems.append(f"{where}: no 'evidence' timing rows; the packaged "
                      f"plan must be measured (repro_torch.tools.autotune)")
    for e in rule.evidence:
      if e not in named:
        problems.append(f"{where}: evidence row {e!r} is in none of "
                        f"{bench_paths}")
      elif e not in timed:
        problems.append(f"{where}: evidence row {e!r} has no finite "
                        f"timing (skipped)")
  return problems


def main(argv: list[str] | None = None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--readme", default=README,
                  help="the README whose port section check 1 reads")
  ap.add_argument("--bench", default=None,
                  help="also assert the backend sweep covers every "
                       "registered forward backend with a real timing")
  ap.add_argument("--bench-projection", default=None,
                  help="also assert the projection sweep covers both paths "
                       "and that fused is not slower than composed")
  ap.add_argument("--plan", default=None, metavar="PLAN_JSON",
                  help="also validate an ExecutionPlan: strict schema, "
                       "registered backends, every rule evidenced")
  ap.add_argument("--plan-bench", default=DEFAULT_BENCH,
                  help="the backend sweep the plan's evidence may cite")
  ap.add_argument("--plan-bench-projection",
                  default=DEFAULT_BENCH_PROJECTION,
                  help="the projection sweep the plan's evidence may cite")
  args = ap.parse_args(sys.argv[1:] if argv is None else argv)

  problems = check_docs_coverage(args.readme)
  checked = ["docs"]
  if args.bench:
    problems += check_bench_artifact(args.bench)
    checked.append(args.bench)
  if args.bench_projection:
    problems += check_projection_artifact(args.bench_projection)
    checked.append(args.bench_projection)
  if args.plan:
    problems += check_plan(args.plan,
                           [args.plan_bench, args.plan_bench_projection])
    checked.append(f"plan:{args.plan}")
  for p in problems:
    print(p, file=sys.stderr)
  print(f"check_backends: {' + '.join(checked)}, {len(problems)} problems")
  return 1 if problems else 0


if __name__ == "__main__":
  raise SystemExit(main())
