"""Markdown tables of the dry run and of BENCH artifacts.

Counterpart of ``repro.analysis.report``, the same tables from the port's
records: §Dry-run and §Roofline from the cell JSONs of
``repro_torch.launch.dryrun`` (trace seconds in place of compile seconds,
the cost model's counts in place of the parsed HLO's), plus §Benchmarks /
§Dispatch metrics from schema-v1 ``BENCH_*.json`` artifacts
(``repro_torch.obs.artifacts``).

  PYTHONPATH=src python -m repro_torch.analysis.report \
      [--dir experiments/dryrun_torch] [--bench 'BENCH_*.json']
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.obs import artifacts as obs_artifacts


def load_cells(directory: str, mesh: str = "single", tagged: bool = False):
  cells = []
  for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
    if path.endswith(".ops.json"):
      continue
    with open(path) as f:
      rec = json.load(f)
    if rec.get("mesh") != mesh:
      continue
    if bool(rec.get("tag")) != tagged:
      continue
    cells.append(rec)
  return cells


def fmt_bytes(b):
  return f"{b / 2**30:.2f}"


def roofline_table(cells) -> str:
  hdr = ("| arch | shape | dominant | compute_s | memory_s | collective_s | "
         "MODEL_FLOPS | useful ratio | roofline frac | mem GiB/dev |\n"
         "|---|---|---|---|---|---|---|---|---|---|\n")
  rows = []
  for rec in cells:
    if rec.get("status") == "skipped":
      rows.append(f"| {rec['arch']} | {rec['shape']} | — skipped: "
                  f"{rec['reason'][:60]}… | | | | | | | |")
      continue
    if rec.get("status") != "ok":
      rows.append(f"| {rec['arch']} | {rec['shape']} | ERROR | | | | | | | |")
      continue
    r = rec["roofline"]
    mem = rec["memory"]["peak_estimate_bytes"]
    rows.append(
        f"| {rec['arch']} | {rec['shape']} | **{r['dominant'][:-2]}** | "
        f"{r['compute_s']*1e3:.1f}ms | {r['memory_s']*1e3:.1f}ms | "
        f"{r['collective_s']*1e3:.1f}ms | {r['model_flops']:.2e} | "
        f"{r['useful_flops_ratio']:.2f} | {r['roofline_fraction']:.3f} | "
        f"{fmt_bytes(mem)} |")
  return hdr + "\n".join(rows)


def dryrun_table(cells, cells_multi) -> str:
  hdr = ("| arch | shape | 16x16 trace | 2x16x16 trace | FLOPs/dev | "
         "HBM GB/dev | coll GB/dev | collectives |\n"
         "|---|---|---|---|---|---|---|---|\n")
  multi = {(r["arch"], r["shape"]): r for r in cells_multi}
  rows = []
  for rec in cells:
    key = (rec["arch"], rec["shape"])
    m = multi.get(key, {})
    if rec.get("status") == "skipped":
      rows.append(f"| {rec['arch']} | {rec['shape']} | skip | skip "
                  f"| | | | {rec['reason'][:40]}… |")
      continue
    if rec.get("status") != "ok":
      rows.append(f"| {rec['arch']} | {rec['shape']} | ERROR | | | | | |")
      continue
    p = rec["cost"]
    colls = ", ".join(f"{k}:{v/1e9:.1f}G"
                      for k, v in sorted(p["collectives_by_type"].items()))
    ok_m = "ok" if m.get("status") == "ok" else m.get("status", "?")
    rows.append(
        f"| {rec['arch']} | {rec['shape']} | ok ({rec['trace_s']:.0f}s) | "
        f"{ok_m} ({m.get('trace_s', 0):.0f}s) | "
        f"{p['flops_per_device']/1e12:.2f}T | "
        f"{p['hbm_bytes_per_device']/1e9:.0f} | "
        f"{p['collective_bytes_per_device']/1e9:.1f} | {colls} |")
  return hdr + "\n".join(rows)


def bench_table(payload: dict) -> str:
  """Markdown table of one BENCH artifact's results (timed + skipped)."""
  hdr = ("| name | backend | shape | us/call | fwd+bwd us | notes |\n"
         "|---|---|---|---|---|---|\n")
  rows = []
  for rec in payload.get("results", []):
    shape = ""
    if "n" in rec or "batch" in rec:
      shape = f"b={rec.get('batch', '?')}, n={rec.get('n', '?')}"
    if "skipped" in rec:
      rows.append(f"| {rec.get('name', '?')} | {rec.get('backend', '—')} | "
                  f"{shape} | — | — | skipped: {rec['skipped'][:60]} |")
      continue
    us = rec.get("fwd_us", rec.get("wall_us"))
    us_txt = f"{us:.1f}" if isinstance(us, (int, float)) else "—"
    bwd = rec.get("fwd_bwd_us")
    bwd_txt = f"{bwd:.1f}" if isinstance(bwd, (int, float)) else "—"
    extra = rec.get("derived", "")
    rows.append(f"| {rec.get('name', '?')} | {rec.get('backend', '—')} | "
                f"{shape} | {us_txt} | {bwd_txt} | {extra} |")
  return hdr + "\n".join(rows)


def metrics_table(payload: dict) -> str:
  """Markdown table of the dispatch counters embedded in an artifact."""
  counters = payload.get("metrics", {}).get("counters", {})
  dispatch = {k: v for k, v in sorted(counters.items())
              if k.startswith("dispatch_")}
  if not dispatch:
    return "_no dispatch counters recorded (REPRO_METRICS disabled?)_"
  hdr = "| counter | value |\n|---|---|\n"
  return hdr + "\n".join(f"| `{k}` | {v} |" for k, v in dispatch.items())


def bench_sections(pattern: str) -> str:
  """§Benchmarks + §Dispatch metrics for every artifact matching pattern."""
  chunks = []
  for path in sorted(glob.glob(pattern)):
    errors = obs_artifacts.validate_file(path)
    if errors:
      chunks.append(f"## §Benchmarks — {os.path.basename(path)}\n\n"
                    f"INVALID artifact:\n" +
                    "\n".join(f"* {e}" for e in errors))
      continue
    with open(path) as f:
      payload = json.load(f)
    meta = payload["meta"]
    prov = (f"platform `{meta['platform']}`, torch "
            f"`{meta.get('torch', 'n/a')}`, jax `{meta['jax']}`, "
            f"sha `{meta['git_sha'][:12]}`")
    chunks.append(f"## §Benchmarks — {os.path.basename(path)} ({prov})\n\n"
                  + bench_table(payload)
                  + "\n\n### §Dispatch metrics\n\n" + metrics_table(payload))
  return "\n\n".join(chunks) if chunks else (
      f"_no artifacts match {pattern!r}_")


def main():
  ap = argparse.ArgumentParser()
  ap.add_argument("--dir", default="experiments/dryrun_torch")
  ap.add_argument("--bench", default=None, metavar="GLOB",
                  help="also render BENCH_*.json artifacts matching GLOB")
  args = ap.parse_args()
  single = load_cells(args.dir, "single")
  multi = load_cells(args.dir, "multi")
  print("## §Dry-run (single-pod 16x16 = 256 ranks; multi-pod 2x16x16 = "
        "512 ranks)\n")
  print(dryrun_table(single, multi))
  print("\n## §Roofline (single-pod; one H100's constants, "
        "repro_torch.analysis.roofline)\n")
  print(roofline_table(single))
  if args.bench:
    print()
    print(bench_sections(args.bench))


if __name__ == "__main__":
  main()
