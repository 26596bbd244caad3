"""The speed sweeps that the packaged execution plan is derived from.

Counterparts of the two sweeps that the reference's ``tools/autotune.py``
calls (``:224-227``):

* :func:`run_backend_sweep` (``benchmarks/bench_runtime.py::
  run_backend_sweep``, ``:109-189``): ``soft_rank`` forward and forward +
  backward (the gradient of ``sum(soft_rank(theta)**2)``, regularization
  strength 0.1) by isotonic backend, both regularizations, over an
  (n, batch) grid; plus the bare solve (``iso_fwd_us``) and its share of
  the forward (``solver_share``).  Rows
  ``backend_sweep/{reg}/{backend}/n={n}/b={batch}``.
* :func:`run_projection` (``benchmarks/bench_projection.py::run``,
  ``:56-127``): the fused and the composed projection pipelines end to end
  on one solver, with rows ``projection/{reg}/{path}/n={n}/b=8`` and
  ``projection/{reg}/speedup/n={n}/b=8``.

Both write schema-v1 artifacts (``repro_torch.obs.artifacts``) with the
reference's grids, names and columns, inputs drawn with
``np.random.default_rng(0)`` in f32, and its warm-up and iteration counts;
times are wall microseconds with the card synchronised around each call
(``repro_torch.obs.timing``), medians.  The port's differences:

* Calls are eager, where the reference's are jitted: a time includes the
  host's launches, which is what a caller of the port pays.
* The backends of one backend-sweep cell, and the two projection paths of
  one cell, are timed in alternation (``timing.time_fns``: each one's
  warm-up calls, then rounds that call each once), where the reference
  times one after the other.  Eager calls on the card are host-bound, and
  the host's load moves medians taken one after the other by tens of
  percent, as much as the differences that the plan and the projection
  guard are made of.
* The projection sweep's solver (``IMPL``) is what the built-in plan
  resolves on the device, ``cuda`` on the card and ``stack`` on the CPU;
  the reference's ``"scan"`` is its off-TPU default.
* Every skip is recorded in its row with the reason, never dropped:
  ``minimax`` keeps the reference's ``batch * n**2 <= 64e6`` cap; the stack
  machine, whose O(n) host loop launches a few ops and reads one flag back
  a position on the card (``kernels/pav.py::_pav_body``), is capped by a
  budget in seconds (:data:`STACK_BUDGET_S`): one forward is timed first
  and the cell is skipped when its calls would pass the budget, the
  counterpart of the reference's cap on the Pallas interpreter
  (``bench_runtime.py:95-107``); on the CPU the ``cuda`` rows are skipped
  with "no card".
* ``meta`` adds ``"dtype": "float32"`` (the plan's rules carry it), the
  backward formulation the forward + backward rows ran (``backward``), the
  card's name and power limit as ``nvidia-smi`` gives them (``card``), and
  the governing plan's provenance.

Both run on the card unless given the CPU; without a card they raise
(``repro_torch.examples.device_of``).
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time

import numpy as np
import torch

from repro_torch import plan as plan_mod
from repro_torch.core.isotonic import isotonic_kl, isotonic_l2
from repro_torch.core.operators import soft_rank
from repro_torch.examples import device_of
from repro_torch.kernels import dispatch
from repro_torch.obs import artifacts
from repro_torch.obs.timing import block_until_ready, time_fn, time_fns

REGS = ("l2", "kl")
EPS = 0.1                        # regularization_strength
DTYPE = "float32"

# Backend sweep (bench_runtime.py:81-91).  1024 is in both tiers: the
# reference states its acceptance bar there.
SWEEP_NS = (100, 1024, 4096, 10000)
SWEEP_BATCHES = (1, 32, 256)
SMOKE_NS = (64, 1024)
SMOKE_BATCHES = (1, 8)

# Projection sweep (bench_projection.py:35-37).
BATCH = 8
PROJ_NS = (1024, 4096)
PROJ_SMOKE_NS = (1024,)

MINIMAX_MAX_ELEMS = 64e6         # batch * n^2 f32 intermediates (~256 MB)
# Seconds one (n, batch, regularization) cell of the stack machine may
# take, reckoned from one timed forward.
STACK_BUDGET_S = 20.0


def card_line(device: torch.device) -> str:
  """The card's name and power limit as ``nvidia-smi --query-gpu=name,
  power.limit --format=csv,noheader`` gives them ("cpu" on the CPU)."""
  if device.type != "cuda":
    return "cpu"
  try:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
  except (OSError, subprocess.SubprocessError) as e:
    return f"not read ({type(e).__name__})"
  lines = out.strip().splitlines()
  index = device.index or 0
  return lines[index] if index < len(lines) else "not read"


def _emit(name: str, us: float, derived: str) -> None:
  """The reference's CSV row, ``name,us_per_call,derived``."""
  print(f"{name},{us:.1f},{derived}")


def _feasibility(backend: str, n: int, batch: int,
                 device: torch.device) -> str:
  """Empty string if runnable, else the reason to skip."""
  if backend == "minimax" and batch * n * n > MINIMAX_MAX_ELEMS:
    return f"minimax needs batch*n^2 = {batch * n * n:.0f} f32 elems"
  if backend == "cuda" and device.type != "cuda":
    return "no card: the cuda kernels take CUDA tensors only"
  return ""


def _over_budget(fwd, theta: torch.Tensor, calls: int,
                 budget_s: float) -> str:
  """Time one forward of the stack machine; the reason to skip when the
  cell's ``calls`` calls would pass ``budget_s`` seconds, else ''."""
  t0 = time.perf_counter()
  block_until_ready(fwd(theta))
  one = time.perf_counter() - t0
  if one * calls <= budget_s:
    return ""
  return (f"stack's O(n) host loop: one forward took {one:.3f} s, the "
          f"cell's {calls} calls ~{one * calls:.1f} s, past the "
          f"{budget_s:g} s budget")


def _squared_grad(fwd):
  """theta -> d sum(fwd(theta)**2) / d theta."""
  def fn(t):
    return torch.autograd.grad((fwd(t) ** 2).sum(), t)[0]
  return fn


def _iso(reg: str, backend: str, theta: torch.Tensor):
  if reg == "l2":
    return (lambda y: isotonic_l2(y, impl=backend)), (theta,)
  return ((lambda s, w: isotonic_kl(s, w, impl=backend)),
          (theta, torch.zeros_like(theta)))


def _backward_ran(device: torch.device, shape) -> str:
  """The Lemma 2 backward that the fused path's forward + backward rows
  resolve to (the chain's choice; no row pins it)."""
  return dispatch.resolve_backward("projection", "l2", None, device,
                                   dtype=DTYPE, shape=shape)


def _meta(device: torch.device, smoke: bool, suite: str, shape,
          **extra) -> dict:
  return artifacts.collect_meta(
      device, smoke=smoke, suite=suite, dtype=DTYPE,
      card=card_line(device), backward=_backward_ran(device, shape),
      **extra, **plan_mod.plan_provenance())


def run_backend_sweep(smoke: bool = False, out_path: str = "runtime.json",
                      device: torch.device | str = "cuda", *,
                      ns=None, batches=None,
                      stack_budget_s: float = STACK_BUDGET_S) -> dict:
  """Time soft_rank fwd and fwd+bwd by backend over n x batch and write the
  schema-v1 artifact; returns its payload (``ns`` / ``batches`` replace
  the tier's grid).  The backends of one (n, batch, regularization) cell
  are timed in alternation (``time_fns``): the cell's winner becomes a
  plan rule, so a change of the host's load must not pick it."""
  device = device_of(str(device))
  ns = tuple(ns or (SMOKE_NS if smoke else SWEEP_NS))
  batches = tuple(batches or (SMOKE_BATCHES if smoke else SWEEP_BATCHES))
  backends = sorted(set(dispatch.registered_backends("isotonic", "l2")))
  rng = np.random.default_rng(0)
  warmup, iters = 1, (2 if smoke else 3)
  calls = 3 * (warmup + iters)

  results = []
  for n in ns:
    for batch in batches:
      theta = torch.from_numpy(
          rng.normal(size=(batch, n)).astype(np.float32)).to(device)
      theta_g = theta.clone().requires_grad_(True)
      recs: dict[tuple[str, str], dict] = {}
      for reg in REGS:
        fwds = {}
        for backend in backends:
          name = f"backend_sweep/{reg}/{backend}/n={n}/b={batch}"
          recs[(backend, reg)] = {
              "name": name, "op": "soft_rank", "regularization": reg,
              "backend": backend, "n": n, "batch": batch}

          def fwd(t, reg=reg, backend=backend):
            return soft_rank(t, EPS, reg, impl=backend)

          skip = _feasibility(backend, n, batch, device)
          if not skip and backend == "stack":
            skip = _over_budget(fwd, theta, calls, stack_budget_s)
          if skip:
            recs[(backend, reg)]["skipped"] = skip
          else:
            fwds[backend] = fwd
        cell = f"backend_sweep/{reg}/n={n}/b={batch}"
        fwd_us = time_fns({b: (f, (theta,)) for b, f in fwds.items()},
                          warmup=warmup, iters=iters, name=cell)
        fwd_bwd_us = time_fns(
            {b: (_squared_grad(f), (theta_g,)) for b, f in fwds.items()},
            warmup=warmup, iters=iters, name=cell + "/bwd")
        # The bare solve: soft_rank's sort and un-permute are shared by
        # every backend and dilute their difference.
        iso_us = time_fns({b: _iso(reg, b, theta) for b in fwds},
                          warmup=warmup, iters=iters, name=cell + "/iso")
        for b in fwds:
          recs[(b, reg)].update(
              fwd_us=fwd_us[b], fwd_bwd_us=fwd_bwd_us[b],
              iso_fwd_us=iso_us[b], e2e_fwd_us=fwd_us[b],
              solver_share=round(iso_us[b] / fwd_us[b], 4))
      for backend in backends:
        for reg in REGS:
          rec = recs[(backend, reg)]
          results.append(rec)
          if "skipped" in rec:
            _emit(rec["name"], float("nan"), f"skipped: {rec['skipped']}")
          else:
            _emit(rec["name"], rec["fwd_us"],
                  f"fwd; bwd={rec['fwd_bwd_us']:.1f}us; "
                  f"iso={rec['iso_fwd_us']:.1f}us; "
                  f"solver_share={rec['solver_share']:.2f}")

  largest = (max(batches), max(ns))
  meta = _meta(
      device, smoke, "backend_sweep", largest,
      default_backend=dispatch.get_default_backend(),
      auto_resolves_to=dispatch.resolve("isotonic", "l2", None, device,
                                        dtype=DTYPE, shape=largest),
      stack_budget_s=stack_budget_s)
  return artifacts.write_bench_artifact(out_path, results, meta)


@contextlib.contextmanager
def _projection_path(path: str):
  """Select the projection path for every call inside the block."""
  prev = os.environ.get(dispatch.PROJECTION_ENV_VAR)
  os.environ[dispatch.PROJECTION_ENV_VAR] = path
  try:
    yield
  finally:
    if prev is None:
      os.environ.pop(dispatch.PROJECTION_ENV_VAR, None)
    else:
      os.environ[dispatch.PROJECTION_ENV_VAR] = prev


def projection_impl(device: torch.device) -> str:
  """The solver both projection paths run: the built-in plan's on the
  device, so the two differ only in the pipeline."""
  rule = plan_mod.builtin_plan().decide("forward", "isotonic", "l2",
                                        platform=device.type, dtype=DTYPE)
  return rule.backend


def run_projection(smoke: bool = False, out_path: str = "projection.json",
                   device: torch.device | str = "cuda", *,
                   ns=None) -> dict:
  """Time both projection paths in the same run and write the schema-v1
  artifact; returns its payload."""
  device = device_of(str(device))
  ns = tuple(ns or (PROJ_SMOKE_NS if smoke else PROJ_NS))
  impl = projection_impl(device)
  rng = np.random.default_rng(0)
  iters = 3 if smoke else 5

  results = []
  for n in ns:
    theta = torch.from_numpy(
        rng.normal(size=(BATCH, n)).astype(np.float32)).to(device)
    theta_g = theta.clone().requires_grad_(True)
    for reg in REGS:
      # The bare solve is the same for both paths: measured once a cell.
      iso, iso_args = _iso(reg, impl, theta)
      iso_fwd_us = time_fn(iso, *iso_args, warmup=1, iters=iters)

      paths = sorted(set(dispatch.registered_backends("projection", reg)))

      def on_path(fn, path):
        def call(t):
          with _projection_path(path):
            return fn(t)
        return call

      def fwd(t, reg=reg):
        return soft_rank(t, EPS, reg, impl=impl)

      # The paths alternate call by call: their ratio is the point.
      cell_name = f"projection/{reg}/n={n}/b={BATCH}"
      e2e_fwd = time_fns({p: (on_path(fwd, p), (theta,)) for p in paths},
                         warmup=2, iters=iters, name=cell_name)
      e2e_fwd_bwd = time_fns(
          {p: (on_path(_squared_grad(fwd), p), (theta_g,)) for p in paths},
          warmup=2, iters=iters, name=cell_name + "/bwd")
      cell: dict[str, dict] = {}
      for path in paths:
        name = f"projection/{reg}/{path}/n={n}/b={BATCH}"
        rec = {
            "name": name, "op": "soft_rank", "regularization": reg,
            "backend": path, "n": n, "batch": BATCH, "impl": impl,
            "e2e_fwd_us": e2e_fwd[path], "e2e_fwd_bwd_us": e2e_fwd_bwd[path],
            "iso_fwd_us": iso_fwd_us,
            "solver_share": round(iso_fwd_us / e2e_fwd[path], 4),
        }
        results.append(rec)
        cell[path] = rec
        _emit(name, e2e_fwd[path],
              f"fwd; fwd+bwd={e2e_fwd_bwd[path]:.1f}us; "
              f"solver_share={rec['solver_share']:.2f}")

      fused, composed = cell.get("fused"), cell.get("composed")
      if fused and composed:
        speedup = composed["e2e_fwd_bwd_us"] / fused["e2e_fwd_bwd_us"]
        name = f"projection/{reg}/speedup/n={n}/b={BATCH}"
        results.append({
            "name": name, "op": "soft_rank", "regularization": reg,
            "backend": "fused_vs_composed", "n": n, "batch": BATCH,
            "impl": impl,
            "fused_fwd_bwd_us": fused["e2e_fwd_bwd_us"],
            "composed_fwd_bwd_us": composed["e2e_fwd_bwd_us"],
            "fwd_speedup_x": round(
                composed["e2e_fwd_us"] / fused["e2e_fwd_us"], 3),
            "speedup_x": round(speedup, 3),
        })
        _emit(name, fused["e2e_fwd_bwd_us"],
              f"fused is {speedup:.2f}x vs composed (fwd+bwd)")

  meta = _meta(
      device, smoke, "projection", (BATCH, max(ns)), batch=BATCH, impl=impl,
      default_path=dispatch.resolve_projection(
          None, "l2", device, dtype=DTYPE, shape=(BATCH, max(ns))))
  return artifacts.write_bench_artifact(out_path, results, meta)


__all__ = [
    "SWEEP_NS", "SWEEP_BATCHES", "SMOKE_NS", "SMOKE_BATCHES", "BATCH",
    "PROJ_NS", "PROJ_SMOKE_NS", "MINIMAX_MAX_ELEMS", "STACK_BUDGET_S",
    "card_line", "projection_impl", "run_backend_sweep", "run_projection",
]
