#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Run from a checkout on a machine with an NVIDIA H100 (sm_90a) and the CUDA
toolkit.  Phases, each printing its own lines; any failure raises and the
script exits non-zero:

1. device   require CUDA; print the card's name and power limit.
2. build    build ``src/repro_torch/kernels/csrc/*.cu`` with nvcc.
3. kernels  hold ``pav_l2`` / ``pav_kl`` against their plain versions on
            the card at (128, 1000) and (128, 2048), on random inputs,
            inputs with ties and constant rows, and a soft-rank dynamic
            range (z = -theta/eps, eps = 1e-2).  At (128, 10000) and
            (1, 2**20) the plain version runs on a CPU copy, in worker
            processes while phase 4 runs, on random rows and on the main
            path's own solver inputs; the comparisons close phase 4.
4. main     fwd+bwd of soft_rank / soft_sort (l2, kl) and
            soft_spearman_loss at (128, 1000) and (128, 10000) (eps 0.1),
            and soft_trimmed_token_loss on 2**20 token losses (trim 0.1,
            eps 1e-2, the trainer's defaults); every launch
            counter must equal the number of its operator calls.  The
            (128, 1000) values and gradients are held against the port on
            the CPU (plain backends), and z = -theta/eps is compared
            across the two devices.
5. times    CUDA-event medians per kernel (on the main path's solver
            inputs and on random rows), plain version, operator fwd and
            fwd+bwd, and torch.sort at the same shape as a yardstick.
6. summary  one ``{"kernels": [...]}`` line, then the device line last.

Inputs come from numpy with a fixed seed.  Imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import json
import multiprocessing
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
TOKENS = 2**20
TRIM_FRACTION = 0.1
TRIM_EPS = 1e-2        # the trainer's default loss_trim_eps
EPS = 0.1              # benchmarks/bench_runtime.py's regularization_strength
SHAPES = ((128, 1000), (128, 10000))
KERNEL_SHAPES = (*SHAPES, (1, TOKENS))
HEADLINE = SHAPES[0]    # the shape of the kernels line
CPU_WORKERS = 4

# H100 SXM data sheet, dense: HBM bandwidth and f32 rate outside the tensor
# cores.  The bound is the larger of bytes / bandwidth and ops / rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations per step of the stack machine, counted from csrc/pav.cu:
#   l2: push 3 (max, div, compare), merge 5 (2 adds, max, div, compare),
#       block 2 (max, div when expanding);
#   kl: push 2 (sub, compare), merge 14 (2 logaddexp of 6 ops each, sub,
#       compare), block 1 (sub).
OPS = {"pav_l2": (3, 5, 2), "pav_kl": (2, 14, 1)}
BYTES_PER_ELEM = {"pav_l2": 8, "pav_kl": 12}
REPLACES = {"pav_l2": "src/repro/kernels/pav.py:196",
            "pav_kl": "src/repro/kernels/pav.py:213"}
SOURCE = "src/repro_torch/kernels/csrc/pav.cu"
OPERATORS = ("soft_rank_l2", "soft_rank_kl", "soft_sort_l2", "soft_sort_kl",
             "soft_spearman_loss")


def check(ok: bool, what: str) -> None:
  if not ok:
    raise RuntimeError(f"check failed: {what}")


def say(*parts) -> None:
  print(*parts, flush=True)


def close(a: torch.Tensor, b: torch.Tensor, rel: float = 1e-5) -> float:
  """Max |a - b|, checked against rel * (1 + max|b|) (the reference's
  cross-backend contract, relative to the output's scale)."""
  a, b = a.detach().double().cpu(), b.detach().double().cpu()
  check(a.shape == b.shape, f"shapes {tuple(a.shape)} vs {tuple(b.shape)}")
  check(bool(torch.isfinite(a).all()), "non-finite values")
  err = float((a - b).abs().max()) if a.numel() else 0.0
  tol = rel * (1.0 + float(b.abs().max()))
  check(err <= tol, f"max |diff| {err:.3e} > {tol:.3e}")
  return err


def median_ms(fn, reps: int, warmup: int = 1) -> float:
  """Median device time of ``fn`` over ``reps`` calls, from CUDA events."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  times = []
  for _ in range(reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return statistics.median(times)


def card() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True, timeout=60).stdout
  return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Inputs (numpy, fixed seed).
# ---------------------------------------------------------------------------


def solver_inputs(rng, rows: int, n: int, kind: str):
  """(y for l2, (s, w) for kl) as f32 numpy arrays of shape (rows, n)."""
  if kind == "random":
    s = rng.normal(size=(rows, n))
    w = rng.normal(size=(rows, n))
    return s - w, (s, w)
  if kind == "ties":
    s = np.round(rng.normal(size=(rows, n)) * 2) / 2
    w = np.round(rng.normal(size=(rows, n)) * 2) / 2
    s[::7] = 1.5   # constant rows
    w[::7] = 0.5
    return s - w, (s, w)
  if kind == "soft_rank":
    eps = 1e-2
    theta = rng.normal(size=(rows, n))
    s = -np.sort(theta, axis=-1) / eps         # sort_desc(-theta / eps)
    w = np.broadcast_to(np.arange(n, 0, -1), (rows, n))
    return s - w, (s, w)
  raise ValueError(kind)


def main_solver_inputs(theta: torch.Tensor | None,
                       tokens: torch.Tensor | None):
  """The main path's (s, w) solver input, computed on the card as the
  operators compute it: soft_rank's sort_desc(-theta / eps) against rho for
  a batch of scores, soft_sort's rho / eps against sort_desc(tokens) for
  the token row."""
  if theta is not None:
    n = theta.shape[-1]
    s = torch.sort(-theta / EPS, descending=True).values
    w = torch.arange(n, 0, -1, device=theta.device,
                     dtype=torch.float32).expand(theta.shape)
  else:
    n = tokens.numel()
    s = (torch.arange(n, 0, -1, device=tokens.device, dtype=torch.float32)
         / TRIM_EPS).expand(1, n)
    w = torch.sort(tokens.reshape(1, n), descending=True).values
  return s.contiguous(), w.contiguous()


def to_dev(x, device) -> torch.Tensor:
  return torch.tensor(np.ascontiguousarray(x), dtype=torch.float32,
                      device=device)


def plain_on_cpu(kname: str, arrays):
  """Worker process: the plain version of ``kname`` on a CPU copy of the
  inputs.  Returns the output and the seconds it took."""
  sys.path.insert(0, str(ROOT / "src"))
  from repro_torch.kernels import pav
  torch.set_num_threads(1)
  t0 = time.perf_counter()
  with torch.inference_mode():
    out = getattr(pav, f"{kname}_stack")(*map(torch.from_numpy, arrays))
  return out.numpy(), time.perf_counter() - t0


def operators(rt):
  """Public entry points of the main path, as ``op(x, target)``."""
  return {
      "soft_rank_l2": lambda x, t: rt.soft_rank(x, EPS, "l2"),
      "soft_rank_kl": lambda x, t: rt.soft_rank(x, EPS, "kl"),
      "soft_sort_l2": lambda x, t: rt.soft_sort(x, EPS, "l2"),
      "soft_sort_kl": lambda x, t: rt.soft_sort(x, EPS, "kl"),
      "soft_spearman_loss": lambda x, t: rt.soft_spearman_loss(x, t, EPS),
      "soft_trimmed_token_loss": lambda x, t: rt.soft_trimmed_token_loss(
          x, TRIM_FRACTION, TRIM_EPS),
  }


def run(op, x_np, t_np, g_np, device):
  """Forward and backward of ``op`` on fresh copies of the inputs."""
  x = to_dev(x_np, device).requires_grad_(True)
  t = None if t_np is None else to_dev(t_np, device)
  out = op(x, t)
  g = to_dev(g_np, device) if out.dim() else torch.ones((), device=device)
  (grad,) = torch.autograd.grad(out, x, g)
  return out.detach(), grad


def main_path(rt, pav, dev, theta_np, target_np, cot_np, tokens_np):
  """Phase 4: the main path once with counters from 0; returns the
  launches and the (out, grad) of every call."""
  ops = operators(rt)
  calls = {"pav_l2": 0, "pav_kl": 0}
  pav.reset_launches()
  results = {}
  for shape in SHAPES:
    for opname in OPERATORS:
      results[(opname, shape)] = run(ops[opname], theta_np[shape],
                                     target_np[shape], cot_np[shape], dev)
      calls["pav_kl" if opname.endswith("_kl") else "pav_l2"] += 1
  results[("soft_trimmed_token_loss", tokens_np.shape)] = run(
      ops["soft_trimmed_token_loss"], tokens_np, None, None, dev)
  calls["pav_l2"] += 1
  torch.cuda.synchronize()
  launches = dict(pav.LAUNCHES)
  say(f"main: launches {launches}, operator calls {calls}")
  for kname in launches:
    check(launches[kname] > 0, f"{kname} was not launched on the main path")
    check(launches[kname] == calls[kname],
          f"{kname}: {launches[kname]} launches for {calls[kname]} calls")

  for (opname, shape), (out, grad) in results.items():
    want = () if opname.endswith("loss") else shape
    check(tuple(out.shape) == want and grad.shape == shape,
          f"{opname} {shape}: shapes {tuple(out.shape)}, {tuple(grad.shape)}")
    check(bool(torch.isfinite(out).all() and torch.isfinite(grad).all()),
          f"{opname} {shape}: non-finite values or gradients")
  token_loss = float(results[("soft_trimmed_token_loss", tokens_np.shape)][0])
  say("main: all outputs and gradients finite, of the expected shapes; "
      f"trimmed token loss {token_loss:.6f}")

  cpu = torch.device("cpu")
  shape = HEADLINE
  for opname in OPERATORS:
    out, grad = results[(opname, shape)]
    ref_out, ref_grad = run(ops[opname], theta_np[shape], target_np[shape],
                            cot_np[shape], cpu)
    e_out, e_grad = close(out, ref_out), close(grad, ref_grad)
    say(f"main: {opname} {shape} card vs CPU port: values {e_out:.3e}, "
        f"gradients {e_grad:.3e} (tol 1e-5 * (1 + max|CPU|))")

  # soft_rank's z = -theta / eps on both devices.  PyTorch's CUDA division
  # by a Python scalar multiplies by the scalar's f32 reciprocal; the CPU
  # divides.
  theta = to_dev(theta_np[shape], cpu)
  z_card = ((-theta.to(dev)) / EPS).cpu()
  z_cpu = (-theta) / EPS
  z_recip = (-theta) * (torch.tensor(1.0) / torch.tensor(EPS))
  differ = int((z_card != z_cpu).sum())
  ulps = float(((z_card - z_cpu).abs() / torch.finfo(torch.float32).eps
                / z_cpu.abs()).max())
  say(f"main: z = -theta/eps {shape}: card differs from CPU division in "
      f"{differ} of {z_cpu.numel()} elements (at most {ulps:.2f} ulp of |z|),"
      f" from CPU multiplication by the f32 reciprocal of eps in "
      f"{int((z_card != z_recip).sum())}")
  return launches


def main() -> int:
  # 1. device ---------------------------------------------------------------
  if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: CUDA is not available\n")
    return 2
  sys.path.insert(0, str(ROOT / "src"))
  import repro_torch as rt
  from repro_torch.kernels import _build, pav, segment_vjp

  dev = torch.device("cuda", 0)
  torch.cuda.set_device(dev)
  name_limit = card()
  say(name_limit)
  say(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
      f"on {torch.cuda.get_device_name(0)}")

  # 2. build ----------------------------------------------------------------
  t0 = time.perf_counter()
  libs = _build.build_all()
  say(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
  for log in _build.BUILD_LOG.values():
    for line in log.splitlines():
      if "registers" in line or "spill" in line:
        say("build:", line.strip())

  # 3. kernels against their plain versions ------------------------------
  rng = np.random.default_rng(SEED)
  # The main path's inputs (phase 4).
  theta_np = {shape: rng.normal(size=shape) for shape in SHAPES}
  target_np = {shape: rng.permuted(np.broadcast_to(
      np.arange(1, shape[1] + 1, dtype=np.float64), shape), axis=-1)
      for shape in SHAPES}
  cot_np = {shape: rng.normal(size=shape) for shape in SHAPES}
  tokens_np = rng.gamma(2.0, 1.25, size=(8, TOKENS // 8))  # per-token CE
  max_err = {"pav_l2": 0.0, "pav_kl": 0.0}

  def record(kname, out, ref):
    err = close(out, ref)
    max_err[kname] = max(max_err[kname], err)
    return err

  for rows, n in ((128, 1000), (128, 2048)):
    for kind in ("random", "ties", "soft_rank"):
      y, (s, w) = solver_inputs(rng, rows, n, kind)
      errs = []
      for kname, args in (("pav_l2", (y,)), ("pav_kl", (s, w))):
        args = [to_dev(a, dev) for a in args]
        out = getattr(pav, kname)(*args)
        errs.append(record(kname, out, getattr(pav, f"{kname}_stack")(*args)))
      say(f"kernels: ({rows}, {n}) {kind}: max |kernel - plain| on the card"
          f" l2 {errs[0]:.3e} kl {errs[1]:.3e} (tol 1e-5 * (1 + max|plain|))")

  # At (128, 10000) and (1, 2**20) the plain version takes tens of seconds
  # per call: it runs on a CPU copy in worker processes (spawned, so they
  # never touch CUDA), the longest first, while phase 4 runs on the card.
  jobs = []
  for rows, n in ((1, TOKENS), (128, 10000)):
    _, (rs, rw) = solver_inputs(rng, rows, n, "random")
    rs, rw = to_dev(rs, dev), to_dev(rw, dev)
    if rows == 1:
      ms, mw = main_solver_inputs(None, to_dev(tokens_np, dev))
    else:
      ms, mw = main_solver_inputs(to_dev(theta_np[(rows, n)], dev), None)
    for kind, (s, w) in (("random", (rs, rw)), ("main", (ms, mw))):
      for kname, args in (("pav_l2", ((s - w).contiguous(),)),
                          ("pav_kl", (s, w))):
        out = getattr(pav, kname)(*args).cpu()
        jobs.append((kname, kind, (rows, n), out,
                     tuple(a.cpu().numpy() for a in args)))

  pool = ProcessPoolExecutor(max_workers=CPU_WORKERS,
                             mp_context=multiprocessing.get_context("spawn"))
  try:
    futures = [pool.submit(plain_on_cpu, job[0], job[4]) for job in jobs]
    say(f"kernels: {len(jobs)} comparisons at (1, {TOKENS}) and (128, 10000)"
        f" handed to {CPU_WORKERS} CPU worker processes")

    # 4. main path ------------------------------------------------------------
    launches = main_path(rt, pav, dev, theta_np, target_np, cot_np,
                         tokens_np)

    t0 = time.perf_counter()
    for (kname, kind, shape, out, _), future in zip(jobs, futures):
      ref, seconds = future.result()
      err = record(kname, out, torch.from_numpy(ref))
      say(f"kernels: {kname} {shape} {kind} input: max |kernel - plain on "
          f"CPU copy| {err:.3e} (tol 1e-5 * (1 + max|plain|); plain "
          f"{seconds:.1f} s on one CPU core)")
    say(f"kernels: waited {time.perf_counter() - t0:.1f} s for the CPU "
        "workers after phase 4")
  finally:
    pool.shutdown(wait=True, cancel_futures=True)

  # 5. times -------------------------------------------------------------------
  lines = []
  kernel_rows = {}
  for rows, n in KERNEL_SHAPES:
    if rows == 1:
      s, w = main_solver_inputs(None, to_dev(tokens_np, dev))
      theta = to_dev(tokens_np.reshape(1, -1), dev)
    else:
      theta = to_dev(theta_np[(rows, n)], dev)
      s, w = main_solver_inputs(theta, None)
    _, (rs, rw) = solver_inputs(rng, rows, n, "random")
    rs, rw = to_dev(rs, dev), to_dev(rw, dev)
    inputs = {("pav_l2", "main"): ((s - w).contiguous(),),
              ("pav_kl", "main"): (s, w),
              ("pav_l2", "random"): (rs - rw,),
              ("pav_kl", "random"): (rs, rw)}
    reps = 5 if rows == 1 else 20
    for (kname, kind), args in inputs.items():
      kernel = getattr(pav, kname)
      out = kernel(*args)
      blocks = int(segment_vjp.block_starts(out).sum())
      push, merge, block = OPS[kname]
      n_ops = rows * n * push + (rows * n - blocks) * merge + blocks * block
      bytes_ms = rows * n * BYTES_PER_ELEM[kname] / HBM_BYTES_PER_S * 1e3
      ops_ms = n_ops / F32_OPS_PER_S * 1e3
      bound_ms = max(bytes_ms, ops_ms)
      bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
      ms = median_ms(lambda: kernel(*args), reps)
      plain_ms = None    # the plain version takes minutes on one long row
      if kind == "main" and (rows, n) in SHAPES:
        plain = getattr(pav, f"{kname}_stack")
        plain_ms = median_ms(lambda: plain(*args), 1, warmup=0)
      if kind == "main":
        kernel_rows[(kname, (rows, n))] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}
      plain_text = ("not measured" if plain_ms is None
                    else f"{plain_ms:.1f} ms")
      lines.append(f"times: {kname} ({rows}, {n}) {kind} input: kernel "
                   f"{ms:.4f} ms, plain {plain_text}, bound {bound_ms:.5f} ms"
                   f" ({bound_by}), {blocks} blocks [{name_limit}]")
    sort_ms = median_ms(
        lambda: torch.sort(theta, dim=-1, descending=True, stable=True), reps)
    lines.append(f"times: torch.sort ({rows}, {n}) {sort_ms:.4f} ms "
                 f"(yardstick, not on the kernel path) [{name_limit}]")

  ops = operators(rt)
  for shape in SHAPES:
    x = to_dev(theta_np[shape], dev).requires_grad_(True)
    t = to_dev(target_np[shape], dev)
    g = to_dev(cot_np[shape], dev)
    for opname in OPERATORS:
      op = ops[opname]
      with torch.no_grad():
        fwd = median_ms(lambda: op(x, t), 10)

      def fwd_bwd():
        out = op(x, t)
        torch.autograd.grad(out, x, g if out.dim() else None)

      both = median_ms(fwd_bwd, 10)
      lines.append(f"times: {opname} {shape} fwd {fwd:.4f} ms, fwd+bwd "
                   f"{both:.4f} ms [{name_limit}]")
  xt = to_dev(tokens_np, dev).requires_grad_(True)
  op = ops["soft_trimmed_token_loss"]
  with torch.no_grad():
    fwd = median_ms(lambda: op(xt, None), 5)
  both = median_ms(lambda: torch.autograd.grad(op(xt, None), xt), 5)
  lines.append(f"times: soft_trimmed_token_loss ({TOKENS},) fwd {fwd:.4f} ms,"
               f" fwd+bwd {both:.4f} ms [{name_limit}]")
  for line in lines:
    say(line)

  # 6. summary -------------------------------------------------------------
  kernels = []
  for kname in ("pav_l2", "pav_kl"):
    row = kernel_rows[(kname, HEADLINE)]
    kernels.append({
        "name": kname, "route": "cuda", "source": SOURCE,
        "replaces": REPLACES[kname], "launches": launches[kname],
        "max_abs_err": max_err[kname], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None,
        "shape": list(HEADLINE)})
  say(json.dumps({"kernels": kernels}))
  say(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
