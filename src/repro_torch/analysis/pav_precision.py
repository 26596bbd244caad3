"""Which f32 PAV solve drifts from f64: the stack machine or the divide
and conquer.

    PYTHONPATH=src python -m repro_torch.analysis.pav_precision [--n N]

On the CPU, for one row of ``n`` positions (2^20 by default), each input
solved three times: in f64 by the divide-and-conquer PAV
(``pav_l2_scan``), and in f32 by the plain stack machine
(``pav_l2_stack``) and by the divide and conquer (``pav_l2_scan``, of
which the card's ``pav_l2`` kernel is bit for bit the plain version).
Rows: ``two_ramps``, two decreasing halves with the right one above the
left (the whole row pools into one block, the divide and conquer's
longest serial chain), divided by eps = 1e-2 as soft rank divides its
scores; ``random``, s - w with s and w ~ N(0, 1) from a seed (a few large
blocks).  Prints, per row and f32 solver, the largest |f32 - f64| in
units of max|f64| and in f32 ulps of the output's size, and the block
counts of the three solves.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.kernels import pav, pav_scan
from repro_torch.kernels.segment_vjp import block_starts

EPS = 1e-2
SEED = 0


def two_ramps(n: int) -> np.ndarray:
  """Two strictly decreasing halves, the right one above the left."""
  half = n // 2
  return np.concatenate([np.linspace(0.0, -1.0, half),
                         np.linspace(2.0, 1.0, n - half)])


def rows(n: int) -> dict[str, np.ndarray]:
  """The measured inputs, each a (1, n) f64 array."""
  rng = np.random.default_rng(SEED)
  return {"two_ramps": two_ramps(n)[None] / EPS,
          "random": rng.normal(size=(1, n)) - rng.normal(size=(1, n))}


def drift(y: np.ndarray) -> dict:
  """The row solved in f64 and in f32 by both solvers: for each f32
  solver the largest |f32 - f64| over max|f64| and in f32 ulps of
  max|f64|, its blocks, and its seconds."""
  t0 = time.perf_counter()
  exact = pav_scan.pav_l2_scan(torch.from_numpy(y))
  res = {"blocks_f64": int(block_starts(exact).sum()),
         "seconds_f64": time.perf_counter() - t0}
  top = float(exact.abs().max())
  ulp = float(np.spacing(np.float32(top)))
  y32 = torch.from_numpy(y.astype(np.float32))
  for name, fn in (("stack", pav.pav_l2_stack),
                   ("divide_and_conquer", pav_scan.pav_l2_scan)):
    t0 = time.perf_counter()
    out = fn(y32)
    seconds = time.perf_counter() - t0
    err = float((out.double() - exact).abs().max())
    res[name] = {"max_abs_err": err, "rel_to_max": err / top,
                 "ulps_of_max": err / ulp,
                 "blocks": int(block_starts(out).sum()), "seconds": seconds}
  return res


def main(argv: list[str] | None = None) -> dict:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--n", type=int, default=2**20)
  args = ap.parse_args(argv)
  torch.set_num_threads(1)
  out = {}
  for name, y in rows(args.n).items():
    res = out[name] = drift(y)
    parts = []
    for solver in ("stack", "divide_and_conquer"):
      r = res[solver]
      parts.append(f"{solver} max |f32 - f64| {r['max_abs_err']:.6e} = "
                   f"{r['rel_to_max']:.3e} of max|f64| = "
                   f"{r['ulps_of_max']:.2f} ulp, {r['blocks']} blocks, "
                   f"{r['seconds']:.1f} s")
    errs = {s: res[s]["max_abs_err"]
            for s in ("stack", "divide_and_conquer")}
    nearer = ("both alike" if len(set(errs.values())) == 1
              else min(errs, key=errs.get))
    print(f"pav_precision: {name} (1, {args.n}): f64 {res['blocks_f64']} "
          f"blocks; {'; '.join(parts)}; nearer f64: {nearer}", flush=True)
  return out


if __name__ == "__main__":
  main()
