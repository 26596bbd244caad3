"""Derive the packaged execution plan from the measured speed sweeps.

  PYTHONPATH=src python -m repro_torch.tools.autotune \\
      [--bench RUNTIME.json] [--bench-projection PROJECTION.json] \\
      [--out PLAN.json] [--run | --smoke] [--dry-run] [--device cpu]

Counterpart of the reference's ``tools/autotune.py`` (``_cells``,
``_midpoint``, ``_bounds``, ``_derive_rules``, ``build_plan``, ``main``,
``:57-236``), with the same derivation: for every measured
``(regularization, n, batch)`` cell of the backend sweep the backend with
the lowest forward + backward time (``fwd_bwd_us``) wins; the winners
become shape-bucket rules with edges at the geometric midpoints of the
measured grid, merged where neighbouring buckets agree, and every rule
cites the timing rows behind it (``evidence``), which
``repro_torch.tools.check_backends --plan`` verifies.  The projection
sweep's cells (``e2e_fwd_bwd_us``) give the projection rules the same way.

By default the plan is derived from the committed artifacts,
``repro_torch/plan/evidence/runtime.json`` and ``projection.json``, and
nothing runs on a device; ``--run`` (the full grid) or ``--smoke`` first
runs the sweeps of ``repro_torch.tools.sweeps`` on the card (``--device
cpu`` on the CPU; without a card they raise) and writes the artifacts.
The plan goes to ``repro_torch/plan/default_plan.json`` and the cached
packaged plan is dropped.

The port's differences, each forced by the card:

* **Platform.** Rules are keyed to the platform the artifact was measured
  on, in the plan's spelling: the artifact's ``"gpu"``
  (``repro_torch.obs.artifacts``) becomes ``"cuda"``, the device type that
  dispatch queries with; a rule keyed ``"gpu"`` would match nothing.  On
  any other platform the packaged plan is silent and the built-in plan
  answers (the CPU resolves as before).
* **Dtype.** Rules carry the artifact's ``meta["dtype"]`` (the sweeps
  time f32), so an f64 solve on the card falls through to the built-in
  plan's ``scan`` rule; an artifact without it, as the reference's are,
  gives ``"*"`` and the reference's rules.
* **Minimax cap.** A winning ``minimax`` rule carries the reference's
  ``rows * n**2`` cap of 16,000,000 (:data:`MINIMAX_MAX_ELEMS`); the
  port's ``plan`` module has no built-in minimax rule to take it from.
* **Backward.** The backward rule pins the formulation that the sweep's
  forward + backward rows ran, ``meta["backward"]`` (what the chain
  resolved on the card), or the reference's ``segscan`` for an artifact
  that does not say; its evidence is the reference's, one winning row per
  (regularization, n) at the smallest batch.
* **Exclusions.** The reference drops ``pallas`` rows off the TPU
  (interpreter timings); kept for its artifacts, it excludes nothing on
  the card, whose sweeps have no such rows.  Skipped rows are never
  candidates.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

from repro_torch import plan as plan_mod
from repro_torch.examples import add_device_arg, device_of

EVIDENCE_DIR = os.path.join(os.path.dirname(plan_mod.__file__), "evidence")
DEFAULT_BENCH = os.path.join(EVIDENCE_DIR, "runtime.json")
DEFAULT_BENCH_PROJECTION = os.path.join(EVIDENCE_DIR, "projection.json")
DEFAULT_OUT = plan_mod.DEFAULT_PLAN_PATH

REGS = ("l2", "kl")
# The artifact's platform word -> the plan's (the tensor's device type).
PLAN_PLATFORMS = {"gpu": "cuda"}
# The reference's BUILTIN_MINIMAX_MAX_ELEMS: rows * n^2 of a minimax rule.
MINIMAX_MAX_ELEMS = 16_000_000
# The reference's sweeps ran its default VJP.
DEFAULT_BACKWARD = "segscan"


def _load(path: str) -> dict:
  with open(path, encoding="utf-8") as f:
    return json.load(f)


def _finite(v) -> bool:
  return (isinstance(v, (int, float)) and not isinstance(v, bool)
          and math.isfinite(v))


def _midpoint(lo: int, hi: int) -> int:
  """Geometric midpoint of two measured grid values (timings scale
  multiplicatively with size, so the crossover belongs on a log axis)."""
  return int(math.sqrt(lo * hi))


def _cells(results: list[dict], metric: str,
           exclude: set[str]) -> dict[tuple, dict[str, tuple]]:
  """{(reg, n, batch): {backend: (timing_us, row_name)}} for rows that
  ran."""
  out: dict[tuple, dict[str, tuple]] = {}
  for r in results:
    if r.get("skipped") or not _finite(r.get(metric)):
      continue
    backend, reg = r.get("backend"), r.get("regularization")
    if backend in exclude or reg not in REGS:
      continue
    key = (reg, r.get("n"), r.get("batch"))
    if None in key:
      continue
    cell = out.setdefault(key, {})
    # Keep the best (lowest) timing if a backend appears twice.
    if backend not in cell or r[metric] < cell[backend][0]:
      cell[backend] = (r[metric], r["name"])
  return out


def _bounds(values: list[int], i_lo: int, i_hi: int):
  """(min, max) bucket bounds covering grid values[i_lo..i_hi] inclusive,
  with open outer edges (the first bucket extrapolates down, the last up)
  and geometric-midpoint inner edges."""
  lo = None if i_lo == 0 else _midpoint(values[i_lo - 1], values[i_lo]) + 1
  hi = (None if i_hi == len(values) - 1
        else _midpoint(values[i_hi], values[i_hi + 1]))
  return lo, hi


def _derive_rules(kind: str, op: str, cells: dict[tuple, dict[str, tuple]],
                  platform: str, dtype: str) -> list[plan_mod.PlanRule]:
  """Winner-per-cell -> merged shape-bucket rules, per regularization.

  For each reg, decide the winner of every measured (n, batch) cell, merge
  consecutive n grid values whose per-batch winner maps agree, then within
  each n-bucket merge consecutive batches (rows == batch in the sweep,
  inputs are (batch, n)) that agree.
  """
  rules: list[plan_mod.PlanRule] = []
  for reg in REGS:
    ns = sorted({n for (r, n, b) in cells if r == reg})
    batches = sorted({b for (r, n, b) in cells if r == reg})
    if not ns:
      continue
    # winner[n][batch] = (backend, evidence_row)
    winner: dict[int, dict[int, tuple]] = {}
    for n in ns:
      for b in batches:
        cell = cells.get((reg, n, b))
        if not cell:
          continue
        best = min(cell, key=lambda k: cell[k][0])
        winner.setdefault(n, {})[b] = (best, cell[best][1])

    def signature(n):
      return {b: w[0] for b, w in winner.get(n, {}).items()}

    # Merge consecutive n values with identical per-batch winner maps.
    groups: list[tuple[int, int]] = []  # (i_lo, i_hi) into ns
    for i, n in enumerate(ns):
      if groups and signature(n) == signature(ns[groups[-1][0]]):
        groups[-1] = (groups[-1][0], i)
      else:
        groups.append((i, i))

    for i_lo, i_hi in groups:
      min_n, max_n = _bounds(ns, i_lo, i_hi)
      group_ns = ns[i_lo:i_hi + 1]
      bmap = winner.get(group_ns[0], {})
      gbatches = sorted(bmap)
      # Merge consecutive batches with the same winning backend.
      bgroups: list[tuple[int, int]] = []
      for j, b in enumerate(gbatches):
        if bgroups and bmap[b][0] == bmap[gbatches[bgroups[-1][0]]][0]:
          bgroups[-1] = (bgroups[-1][0], j)
        else:
          bgroups.append((j, j))
      for j_lo, j_hi in bgroups:
        backend = bmap[gbatches[j_lo]][0]
        min_rows, max_rows = ((None, None) if len(bgroups) == 1
                              else _bounds(gbatches, j_lo, j_hi))
        evidence = tuple(
            winner[n][b][1] for n in group_ns
            for b in gbatches[j_lo:j_hi + 1] if b in winner.get(n, {}))
        rules.append(plan_mod.PlanRule(
            kind, backend, op=op, regularization=reg, platform=platform,
            dtype=dtype, min_n=min_n, max_n=max_n, min_rows=min_rows,
            max_rows=max_rows,
            max_elems=MINIMAX_MAX_ELEMS if backend == "minimax" else None,
            evidence=evidence))
  return rules


def build_plan(runtime_payload: dict,
               projection_payload: dict) -> plan_mod.ExecutionPlan:
  """The plan that two sweep artifacts' timings support."""
  run_meta = runtime_payload.get("meta", {})
  measured_on = run_meta.get("platform", "cpu")
  platform = PLAN_PLATFORMS.get(measured_on, measured_on)
  dtype = run_meta.get("dtype", "*")
  exclude = {"pallas"} if measured_on != "tpu" else set()

  sweep = [r for r in runtime_payload.get("results", [])
           if r.get("name", "").startswith("backend_sweep/")]
  fwd_cells = _cells(sweep, "fwd_bwd_us", exclude)
  rules = _derive_rules("forward", "isotonic", fwd_cells, platform, dtype)

  # The sweep's fwd+bwd timings ran one backward formulation end to end:
  # pin it, evidenced by one winning row per (reg, n).
  bwd_evidence = tuple(dict.fromkeys(
      min(cell.values(), key=lambda v: v[0])[1]
      for key, cell in sorted(fwd_cells.items(), key=str)
      if key[2] == min(b for (_, _, b) in fwd_cells)))
  if bwd_evidence:
    rules.append(plan_mod.PlanRule(
        "backward", run_meta.get("backward", DEFAULT_BACKWARD),
        platform=platform, dtype=dtype, evidence=bwd_evidence))

  proj_cells = _cells(projection_payload.get("results", []),
                      "e2e_fwd_bwd_us", exclude=set())
  rules.extend(_derive_rules("projection", "projection", proj_cells,
                             platform, dtype))

  meta = {
      "generated_by": "repro_torch.tools.autotune",
      "platform": platform,
      "dtype": dtype,
      "derived_from": {
          "runtime": run_meta.get("git_sha", "?"),
          "projection": projection_payload.get("meta", {}).get(
              "git_sha", "?"),
      },
      "cells": {"runtime": len(fwd_cells), "projection": len(proj_cells)},
  }
  if "card" in run_meta:
    meta["card"] = run_meta["card"]
  plan = plan_mod.ExecutionPlan(name=f"autotuned-{platform}",
                                rules=tuple(rules), meta=meta)
  return plan


def main(argv: list[str] | None = None) -> int:
  ap = argparse.ArgumentParser(
      description="derive default_plan.json from the sweep artifacts")
  ap.add_argument("--bench", default=DEFAULT_BENCH)
  ap.add_argument("--bench-projection", default=DEFAULT_BENCH_PROJECTION)
  ap.add_argument("--out", default=DEFAULT_OUT)
  ap.add_argument("--run", action="store_true",
                  help="run the full sweeps on the device first")
  ap.add_argument("--smoke", action="store_true",
                  help="run the reduced (smoke) sweeps first")
  ap.add_argument("--dry-run", action="store_true",
                  help="print the derived plan JSON without writing")
  add_device_arg(ap)
  args = ap.parse_args(sys.argv[1:] if argv is None else argv)

  if args.run or args.smoke:
    from repro_torch.tools import sweeps
    device = device_of(args.device)
    for path in (args.bench, args.bench_projection):
      os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    sweeps.run_backend_sweep(smoke=args.smoke, out_path=args.bench,
                             device=device)
    sweeps.run_projection(smoke=args.smoke, out_path=args.bench_projection,
                          device=device)

  plan = build_plan(_load(args.bench), _load(args.bench_projection))
  if args.dry_run:
    print(plan.to_json())
    return 0
  plan.save(args.out)
  plan_mod.invalidate_default_plan_cache()
  print(f"autotune: wrote {args.out} — {len(plan.rules)} rules, "
        f"hash {plan.plan_hash()}")
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
