"""Read the two ends that a cell's limits are set between, on the card.

    python -m chipbench.calibrate --workload <cell> --seeds 1,2,... \
        --control-seeds 3,4,5 [--seconds 3]

For each seed, in one process: the cell's set-up and a short window at its
own sizes, then the program's numbers against the reference (the lower
reading is their largest over the seeds).  For each control seed besides:
the reference computed in float8 put in the program's place (the control;
the upper reading is its smallest), and for a training cell the planted
fault "half of the batch left out, the mean taken over the rest" (the
reference on half of each step's microbatches) against the whole
reference.  A state left unchanged reads 1 on the change by its measure
and needs no run.  One JSON line a seed to standard output.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from chipbench import run as R


def one(name: str, seed: int, seconds: float, control: bool) -> dict:
  import torch
  from chipbench.reference import model as M

  env = R.Env.load(name, seed, "cuda")
  cell = R.cell_class(env)(env)
  t0 = time.perf_counter()
  torch.cuda.reset_peak_memory_stats()
  cell.setup()
  env.sync()
  setup_s = time.perf_counter() - t0
  out = cell.window(seconds)
  peak = torch.cuda.max_memory_allocated()
  cell.release()
  t1 = time.perf_counter()
  row = {"seed": seed, "setup_s": setup_s, "window": out, "peak": peak}
  if env.traffic["kind"] == "train":
    ref = cell.reference(M.F32)
    row["program"] = cell.compare(cell.recorded, ref)
    row["loss"] = {"program": cell.recorded["loss"], "reference": ref["loss"]}
    if control:
      row["control"] = cell.compare(cell.reference(M.FP8), ref)
      row["half_batch"] = cell.compare(cell.reference(M.F32, True), ref)
  elif control:
    row.update(cell.readings(control=True))
  else:
    row["program"] = cell.readings()
  row["reference_s"] = time.perf_counter() - t1
  if getattr(cell, "detail", None) is not None:
    row["detail"] = cell.detail
  del cell
  gc.collect()
  torch.cuda.empty_cache()
  return row


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seeds", default="")
  ap.add_argument("--control-seeds", default="")
  ap.add_argument("--seconds", type=float, default=3.0)
  args = ap.parse_args(argv)
  sys.path.insert(0, str(R.ROOT / "src"))
  seeds = [int(s) for s in args.seeds.split(",") if s]
  ctl = [int(s) for s in args.control_seeds.split(",") if s]
  for seed in seeds + ctl:
    print(json.dumps(one(args.workload, seed, args.seconds, seed in ctl)),
          flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
