#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py

Run from a checkout on a machine with an NVIDIA H100 (sm_90a) and the CUDA
toolkit.  Three paths run on the card: the operator chain (soft rank /
sort and the losses, on the PAV kernels), the LM server of
deepseek-v2-lite-16b at full width and depth (on the soft top-k router and
flash-attention kernels) and its trainer at full width (on the PAV kernel
and flash attention under autograd).  Phases, each printing its own
lines; any failure raises and the script exits non-zero:

1. device   require CUDA; print the card's name and power limit.
2. build    build ``src/repro_torch/kernels/csrc/*.cu`` with nvcc, one
            process per source, in parallel.
3. kernels  hold ``pav_l2`` / ``pav_kl`` (both divide and conquer) against
            the plain stack machine on the card at (128, 1000) and
            (128, 2048), on random inputs, inputs with ties and constant
            rows, and a soft-rank dynamic range (z = -theta/eps, eps =
            1e-2).  Hold each against its own plain version, the
            divide-and-conquer ``pav_l2_scan`` / ``pav_kl_scan``, at
            (128, 1000), (128, 10000) and (1, 2**20) on the main path's
            solver inputs, random rows and an adversarial row (two
            decreasing ramps, the right one above the left, which the top
            level pools into one block), bit for bit (kl: or within
            1e-5 * (1 + max|plain|) with the reason printed), with the
            blocks that the backward reads from each output.  At
            (128, 10000) and (1, 2**20) the stack machine (its block counts
            too, for kl), the adversarial 2**20 rows' plain versions and the
            trimmed token loss's fwd+bwd on the port's CPU backend run on a
            CPU copy, in worker processes while phase 4 runs, on random
            rows and on the main path's own solver inputs; the comparisons
            close phase 4.  Hold ``soft_topk_gates`` bit for bit (at
            (4096, 64) and (8, 64), k = 6, on random logits, ties and
            constant rows, at E = 100, at k = 0, 1 and E, and at eps = 0.3,
            not a power of two, and 1e-2) and ``flash_attention`` (the
            prefill shape, a GQA shape and a ragged S, by the kernel's
            error model ``compare_with_plain``) against their plain
            versions on the card.
4. main     fwd+bwd of soft_rank / soft_sort (l2, kl) and
            soft_spearman_loss at (128, 1000) and (128, 10000) (eps 0.1),
            and soft_trimmed_token_loss on 2**20 token losses (trim 0.1,
            eps 1e-2, the trainer's defaults); every launch
            counter must equal the number of its operator calls.  The
            (128, 1000) values and gradients are held against the port on
            the CPU (plain backends), and z = -theta/eps is compared
            across the two devices.
   serve    ``repro_torch.launch.serve`` on deepseek-v2-lite-16b: random
            bf16 weights from seed 0, 8 prompts of 512 tokens from the
            port's TokenPipeline, prefill and 31 greedy decode steps.  Each
            prefill launches flash_attention and soft_topk_gates once per
            layer (27), each decode step soft_topk_gates 27 times, and no
            PAV kernel runs.  Logits are finite and every gate row sums to
            k.  Each kernel is held against its plain version on the inputs
            it got in every layer of that prefill (the gates bit for bit);
            a second prefill on the plain versions counts the routing
            decisions that differ.
5. times    CUDA-event medians per kernel (on the main path's solver
            inputs and on random rows), plain version, operator fwd and
            fwd+bwd, and torch.sort at the same shape as a yardstick; the
            serving kernels at the path's shapes (CUDA events, and each
            kernel's own device time from torch.profiler) beside their
            plain versions and, for attention,
            scaled_dot_product_attention as the library yardstick;
            prefill ms and decode tokens/s; one profiled prefill and
            decode step (device busy and idle share, top kernels).
6. train    the server's model freed, ``repro_torch.launch.train``'s
            ``main`` on deepseek-v2-lite-16b at full width and 4 of 27
            layers (the trainer's state at full depth, ~260 GB, needs
            several cards): random bf16 weights from seed 0, 4 AdamW steps
            of 8 x 2048 tokens with 10% corrupted targets, the config's
            grad_accum 8 and remat "full", the soft-LTS token loss (trim
            0.1).  Every step's launch counts equal the counts from the
            code (``train_launches_per_step``); losses and grad norms are
            finite; after step 1 every parameter leaf has a finite,
            non-zero gradient.  On captured inputs at the training shape:
            the attention kernel's forward and ``flash_attention_bwd``
            (against the autograd of the plain version in f32) by their
            error models; the router's ``soft_topk_mask`` fwd+bwd against
            the ``scan`` backend on the card; one AdamW update of an expert
            leaf, card against CPU, within one f32 ulp.  Then the step ms,
            tokens/s and peak memory, attention forward and backward
            beside scaled_dot_product_attention's, and one profiled step.
7. summary  one ``{"kernels": [...]}`` line, then the device line last.

Inputs come from numpy with a fixed seed.  Imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import gc
import json
import math
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
CPU_WORKERS = 6

# H100 SXM data sheet, dense: HBM bandwidth and f32 rate outside the tensor
# cores.  The bound is the larger of bytes / bandwidth and ops / rate.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations of the isotonic fit on these inputs, counted from
# csrc/pav_scan.cu: each position's singleton value and compare, each merge
# of two blocks (n - blocks of them), each block's value when expanding:
#   l2: position 3 (max, div, compare), merge 5 (2 adds, max, div,
#       compare), block 2 (max, div);
#   kl: position 2 (sub, compare), merge 14 (2 logaddexp of 6 ops each,
#       sub, compare), block 1 (sub).
OPS = {"pav_l2": (3, 5, 2), "pav_kl": (2, 14, 1)}
BYTES_PER_ELEM = {"pav_l2": 8, "pav_kl": 12}
REPLACES = {"pav_l2": "src/repro/kernels/pav.py:196",
            "pav_kl": "src/repro/kernels/pav.py:213",
            "soft_topk_gates": "src/repro/kernels/soft_topk.py:109",
            "flash_attention": "src/repro/kernels/flash_attention.py:83"}
# Names of each PAV kernel's CUDA kernels as the profiler shows them: the
# four kernels of each instantiation of csrc/pav_scan.cu carry its algebra
# in their template names.
DEVICE_NAMES = {"pav_l2": ("L2Algebra",), "pav_kl": ("KlAlgebra",)}
SOURCES = {"pav_l2": "src/repro_torch/kernels/csrc/pav_scan.cu",
           "pav_kl": "src/repro_torch/kernels/csrc/pav_scan.cu",
           "soft_topk_gates": "src/repro_torch/kernels/csrc/soft_topk.cu",
           "flash_attention":
               "src/repro_torch/kernels/csrc/flash_attention.cu"}
# The LM serving path: full config, 8 prompts of 512 tokens, 32 tokens out.
ARCH = "deepseek-v2-lite-16b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 512, 32
BF16_OPS_PER_S = 989e12   # H100 SXM tensor cores, dense bf16
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


def two_ramps(rows: int, n: int) -> np.ndarray:
  """Each row: two strictly decreasing halves, the right one above the
  left.  Every merge level below the top is already solved, and the top
  level pools the whole row into one block, absorbing one block on each
  side per step: the divide-and-conquer PAV's longest serial chain."""
  half = n // 2
  row = np.concatenate([np.linspace(0.0, -1.0, half),
                        np.linspace(2.0, 1.0, n - half)])
  return np.tile(row, (rows, 1))


def pav_inputs(rng, dev, rows: int, n: int, theta_np, tokens_np):
  """The solver inputs of phase 3, on the card, by (kernel, kind): the
  main path's own, a random row, and the adversarial two ramps (kl: as s,
  with w = 0)."""
  if rows == 1:
    s, w = main_solver_inputs(None, to_dev(tokens_np, dev))
  else:
    s, w = main_solver_inputs(to_dev(theta_np[(rows, n)], dev), None)
  _, (rs, rw) = solver_inputs(rng, rows, n, "random")
  rs, rw = to_dev(rs, dev), to_dev(rw, dev)
  ramps = to_dev(two_ramps(rows, n), dev)
  return {("pav_l2", "main"): ((s - w).contiguous(),),
          ("pav_l2", "random"): ((rs - rw).contiguous(),),
          ("pav_l2", "adversarial"): (ramps,),
          ("pav_kl", "main"): (s, w),
          ("pav_kl", "random"): (rs, rw),
          ("pav_kl", "adversarial"): (ramps, torch.zeros_like(ramps))}


# Why pav_kl may differ from pav_kl_scan in the last bit while pav_l2 may
# not: the kl merge is a logaddexp (expf, log1pf), the l2 merge an add.
KL_ON_CARD = ("the kernel's expf / log1pf and those of PyTorch's build "
              "(torch.logaddexp on the card) round an ulp apart")
KL_ON_CPU = ("the plain version ran on the CPU, whose torch.logaddexp "
             "rounds otherwise than the card's")


def hold(kname: str, what: str, out, plain, record, reason=None,
         blocks: bool = True) -> str:
  """``out`` against its plain version: within 1e-5 * (1 + max|plain|),
  bit for bit unless ``reason`` says why an ulp may differ, and (with
  ``blocks``) with the same blocks, which the backward reads from equal
  adjacent outputs.  Returns the line's text."""
  from repro_torch.kernels import segment_vjp
  err = record(kname, out, plain)
  differ = int((out != plain).sum())
  check(differ == 0 or reason is not None,
        f"{kname} {what}: {differ} elements not bit for bit")
  text = (f"max |kernel - plain| {err:.3e} (tol 1e-5 * (1 + max|plain|)), "
          f"{differ} of {out.numel()} elements not bit for bit")
  if differ:
    text += f" (they may: {reason})"
  if blocks:
    nb = [int(segment_vjp.block_starts(v).sum()) for v in (out, plain)]
    check(nb[0] == nb[1], f"{kname} {what}: blocks {nb}")
    text += f"; {nb[0]} blocks in both"
  return text


def plain_on_cpu(fn_name: str, arrays):
  """Worker process: the plain version ``fn_name`` (of ``kernels.pav`` or
  ``kernels.pav_scan``) on a CPU copy of the inputs.  Returns the output
  and the seconds it took."""
  sys.path.insert(0, str(ROOT / "src"))
  from repro_torch.kernels import pav, pav_scan
  torch.set_num_threads(1)
  fn = getattr(pav, fn_name, None) or getattr(pav_scan, fn_name)
  t0 = time.perf_counter()
  with torch.inference_mode():
    out = fn(*map(torch.from_numpy, arrays))
  return out.numpy(), time.perf_counter() - t0


def token_loss_on_cpu(tokens: np.ndarray):
  """Worker process: soft_trimmed_token_loss fwd+bwd with the port's CPU
  backend.  Returns the value, the gradient and the seconds it took."""
  sys.path.insert(0, str(ROOT / "src"))
  import repro_torch as rt
  torch.set_num_threads(1)
  t0 = time.perf_counter()
  x = torch.tensor(tokens, dtype=torch.float32, requires_grad=True)
  out = rt.soft_trimmed_token_loss(x, TRIM_FRACTION, TRIM_EPS)
  (grad,) = torch.autograd.grad(out, x)
  return (out.detach().numpy(), grad.numpy()), time.perf_counter() - t0


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
  token_run = results[("soft_trimmed_token_loss", tokens_np.shape)]
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
  return launches, token_run


# ---------------------------------------------------------------------------
# The LM serving path (deepseek-v2-lite-16b) and its kernels.
# ---------------------------------------------------------------------------


def gates_inputs(rng, rows: int, e: int, kind: str) -> np.ndarray:
  """Router logits: N(0, 1), ties on a grid of 0.5, or constant rows."""
  x = rng.normal(size=(rows, e))
  if kind == "ties":
    x = np.round(x * 2) / 2
  elif kind == "constant":
    x[:] = 0.75
  return x


def attn_close(out: torch.Tensor, q, k, v, causal: bool, fa) -> dict:
  """The kernel's output against the plain version in f32 on the same
  bf16 inputs, by its error model (``fa.compare_with_plain``): every
  element within 2 * 2**-8 * (|ref| + A), A the attention over |v|
  (tol_ratio <= 1), and ||out - ref||_F <= REL_FROB_LIMIT * ||ref||_F."""
  cmp = fa.compare_with_plain(out, q, k, v, causal)
  check(cmp["finite"], "attention: non-finite output")
  check(cmp["tol_ratio"] <= 1.0 and cmp["rel_frob"] <= fa.REL_FROB_LIMIT,
        f"attention: {attn_text(cmp, fa)}")
  return cmp


def attn_text(cmp: dict, fa, diff: str = "kernel - plain in f32") -> str:
  return (f"max |{diff}| {cmp['max_abs_err']:.3e}, worst "
          f"|err| / tol {cmp['tol_ratio']:.3f} (limit 1; tol = 2**-7 * (|ref|"
          f" + A)), relative Frobenius error {cmp['rel_frob']:.3e} (limit "
          f"{fa.REL_FROB_LIMIT:.3e}), median |ref| {cmp['median_ref']:.3e}")


def serve_kernel_checks(rng, dev, st, fa, record, max_err) -> None:
  """Phase 3, serving kernels: each against its plain version on the card
  (the gates bit for bit)."""
  for rows, e, kind, k, eps in ((4096, 64, "random", 6, 1.0),
                                (4096, 64, "ties", 6, 1.0),
                                (4096, 64, "constant", 6, 1.0),
                                (8, 64, "random", 6, 1.0),
                                (8, 64, "ties", 6, 1.0),
                                (333, 100, "random", 6, 1.0),
                                (4096, 64, "random", 6, 0.3),
                                (8, 64, "ties", 6, 0.3),
                                (4096, 64, "random", 6, 1e-2),
                                (8, 64, "ties", 6, 1e-2),
                                (333, 100, "ties", 0, 1.0),
                                (333, 100, "ties", 1, 1.0),
                                (333, 100, "random", 100, 1.0),
                                (333, 128, "ties", 6, 1.0),
                                (333, 20, "ties", 6, 1.0)):
    x = to_dev(gates_inputs(rng, rows, e, kind), dev)
    out = st.soft_topk_gates(x, k, eps)
    plain = st.soft_topk_gates_plain(x, k, eps)
    text = hold("soft_topk_gates", f"({rows}, {e}) k {k} eps {eps} {kind}",
                out, plain, record, blocks=False)
    sums = float((out.sum(-1) - k).abs().max())
    check(sums <= 1e-4, f"gates row sums off k by {sums:.3e}")
    say(f"kernels: soft_topk_gates ({rows}, {e}) k {k} eps {eps} {kind}: "
        f"{text}; row sums within {sums:.1e} of k")
  for b, s, h, hkv, causal in ((SERVE_BATCH, SERVE_PROMPT, 16, 16, True),
                               (2, 512, 16, 4, True), (3, 333, 16, 16, True),
                               (2, 200, 16, 4, False)):
    gen = torch.Generator(device=dev).manual_seed(s)
    q, k = (torch.randn((b, s, n, 192), generator=gen, device=dev,
                        dtype=torch.bfloat16) for n in (h, hkv))
    v = torch.randn((b, s, hkv, 128), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    cmp = attn_close(fa.flash_attention(q, k, v, causal), q, k, v, causal,
                     fa)
    max_err["flash_attention"] = max(max_err["flash_attention"],
                                     cmp["max_abs_err"])
    say(f"kernels: flash_attention q ({b}, {s}, {h}, 192) kv heads {hkv} "
        f"causal {causal}: {attn_text(cmp, fa)}")


def pav_scan_checks(rng, dev, pav, pav_scan, theta_np, tokens_np, record,
                    jobs) -> None:
  """Phase 3: ``pav_l2`` / ``pav_kl`` against their plain versions
  ``pav_l2_scan`` / ``pav_kl_scan`` (the same divide-and-conquer merges in
  the same order) on the card, at every kernel shape, on the main, random
  and adversarial inputs; ``pav_kl`` also against the stack machine, with
  the same blocks, at (128, 1000).  The 2**20 adversarial rows' plain
  versions (2**19 steps of small ops at the top level) go to the CPU
  workers."""
  for rows, n in KERNEL_SHAPES:
    inputs = pav_inputs(rng, dev, rows, n, theta_np, tokens_np)
    for (kname, kind), args in inputs.items():
      out = getattr(pav, kname)(*args)
      plain_fn = f"{kname}_scan"
      if rows == 1 and kind == "adversarial":
        jobs.insert(0, (kname, f"{kind} input, plain divide and conquer",
                        (rows, n), out.cpu(), plain_fn,
                        tuple(a.cpu().numpy() for a in args)))
        continue
      plain = getattr(pav_scan, plain_fn)(*args)
      reason = KL_ON_CARD if kname == "pav_kl" else None
      say(f"kernels: {kname} ({rows}, {n}) {kind} input, plain divide and "
          f"conquer on the card: "
          f"{hold(kname, f'{(rows, n)} {kind}', out, plain, record, reason)}")
      if kname == "pav_kl" and (rows, n) == HEADLINE and kind != "adversarial":
        stack = pav.pav_kl_stack(*args)
        say(f"kernels: pav_kl ({rows}, {n}) {kind} input, plain stack "
            "machine on the card: " +
            hold("pav_kl vs stack", f"{(rows, n)} {kind}", out, stack,
                 record, "the stack machine pools in another order"))


class Recorder:
  """Wraps the kernel wrappers the models call (module attributes of
  ``soft_topk`` and ``flash_attention``) to keep each call's inputs and
  output; ``plain=True`` routes the calls to the plain versions instead."""

  def __init__(self, st, fa, plain: bool = False):
    self.st, self.fa, self.plain = st, fa, plain
    self.gates: list[tuple] = []    # (logits, k, eps, gates)
    self.attn: list[tuple] = []     # (q, k, v, causal, out)

  def __enter__(self):
    self._orig = (self.st.soft_topk_gates, self.fa.flash_attention)
    gates_fn = self.st.soft_topk_gates_plain if self.plain else self._orig[0]
    plain_fa = self.fa.flash_attention_plain

    def gates(logits, k, eps=1.0):
      out = gates_fn(logits, k, eps)
      self.gates.append((logits, k, eps, out))
      return out

    def attn(q, k, v, causal=True, **opts):
      out = (plain_fa(q, k, v, causal=causal, **opts) if self.plain
             else self._orig[1](q, k, v, causal, **opts))
      self.attn.append((q, k, v, causal, out))
      return out

    self.st.soft_topk_gates, self.fa.flash_attention = gates, attn
    return self

  def __exit__(self, *exc):
    self.st.soft_topk_gates, self.fa.flash_attention = self._orig


def routed_experts(logits: torch.Tensor, gates: torch.Tensor,
                   k: int) -> torch.Tensor:
  """The k experts each token is sent to first (the dispatch's rounds of
  argmax over gates * softmax(logits), before capacity), as a 0/1 mask."""
  w = gates * torch.softmax(logits, dim=-1)
  top = torch.topk(w, k, dim=-1).indices
  return torch.zeros_like(w, dtype=torch.bool).scatter_(-1, top, True)


def serve_path(dev, serve, ops, st, fa):
  """The serving path once with every counter from 0, then its checks.

  Returns (serve result, launches, kernel-path recorder, the worst error
  per kernel on the captured inputs)."""
  args = serve.parser().parse_args(
      ["--arch", ARCH, "--batch", str(SERVE_BATCH), "--prompt-len",
       str(SERVE_PROMPT), "--gen", str(SERVE_GEN)])
  from repro_torch.configs.base import get_config
  from repro_torch.models import transformer as T

  t0 = time.perf_counter()
  torch.cuda.reset_peak_memory_stats(dev)
  model = T.init_params(get_config(ARCH), args.seed, dev)
  torch.cuda.synchronize()
  say(f"serve: {ARCH} initialised on the card in "
      f"{time.perf_counter() - t0:.1f} s")

  ops.reset_all_launches()
  with Recorder(st, fa) as rec:
    res = serve.run_lm(args, model=model)
  torch.cuda.synchronize()
  launches = ops.all_launches()
  cfg = res["cfg"]
  n_layers, k = cfg.num_layers, cfg.experts_per_token
  steps = SERVE_GEN - 1
  say(f"serve: launches {launches} for 1 prefill and {steps} decode steps"
      f" of {n_layers} layers")
  n_prefill_gates = sum(1 for g in rec.gates if g[0].shape[0] ==
                        SERVE_BATCH * SERVE_PROMPT)
  check(launches["flash_attention"] == n_layers == len(rec.attn),
        f"flash_attention: {launches['flash_attention']} launches, "
        f"{n_layers} layers")
  check(launches["soft_topk_gates"] == n_layers * (1 + steps)
        == len(rec.gates) and n_prefill_gates == n_layers,
        f"soft_topk_gates: {launches['soft_topk_gates']} launches for "
        f"{n_layers} x {1 + steps} calls")
  check(launches["pav_l2"] == launches["pav_kl"] == 0,
        "a PAV kernel ran on the serving path")
  params = T.count_params(res["model"])
  check(abs(params - 16.21e9) < 0.01e9, f"{params} parameters")
  for name in ("prefill_logits", "logits"):
    logits = res[name]
    check(tuple(logits.shape) == (SERVE_BATCH, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), f"{name}: not finite")
  sums = max(float((g[3].sum(-1) - k).abs().max()) for g in rec.gates)
  check(sums <= 1e-4, f"gate row sums off k by {sums:.3e}")
  say(f"serve: {params:,} parameters; logits finite; every gate row sums "
      f"to k within {sums:.1e}; peak memory "
      f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

  # Each kernel against its plain version on the inputs of every layer.
  worst = {"soft_topk_gates": 0.0, "flash_attention": 0.0}
  for logits, kk, eps, out in rec.gates[:n_layers]:
    plain = st.soft_topk_gates_plain(logits, kk, eps)
    check(torch.equal(out, plain), "soft_topk_gates: a captured layer's "
          f"gates differ from the plain version in "
          f"{int((out != plain).sum())} elements")
    worst["soft_topk_gates"] = max(worst["soft_topk_gates"],
                                   close(out, plain))
  worst_bf16 = 0.0
  worst_attn = {"max_abs_err": 0.0, "tol_ratio": 0.0, "rel_frob": 0.0,
                "median_ref": math.inf}
  for q, kx, v, causal, out in rec.attn:
    cmp = attn_close(out, q, kx, v, causal, fa)
    for key in ("max_abs_err", "tol_ratio", "rel_frob"):
      worst_attn[key] = max(worst_attn[key], cmp[key])
    worst_attn["median_ref"] = min(worst_attn["median_ref"],
                                   cmp["median_ref"])
    plain16 = fa.flash_attention_plain(q, kx, v, causal=causal)
    worst_bf16 = max(worst_bf16, float((out.float() - plain16.float())
                                       .abs().max()))
  worst["flash_attention"] = worst_attn["max_abs_err"]
  say(f"serve: on the captured inputs of all {n_layers} layers: "
      f"soft_topk_gates max |kernel - plain| {worst['soft_topk_gates']:.3e}"
      f" (tol 1e-5 * (1 + max|plain|)); flash_attention, worst layer by "
      f"each measure (median |ref|: the smallest layer's), "
      f"{attn_text(worst_attn, fa)}; max |kernel - plain in bf16| "
      f"{worst_bf16:.3e} (the reference's rounding, no tolerance)")

  # The same prefill on the plain versions: routing decisions that differ.
  with Recorder(st, fa, plain=True) as plain_rec:
    plain_res = serve.generate(cfg, model, res["prompts"], 1)
  check(len(plain_rec.gates) == len(plain_rec.attn) == n_layers,
        "the plain prefill did not pass every layer")
  per_layer, tokens_differ = [], 0
  for a, b in zip(rec.gates[:n_layers], plain_rec.gates):
    ra, rb = routed_experts(a[0], a[3], k), routed_experts(b[0], b[3], k)
    per_layer.append(int((ra & ~rb).sum()))
    tokens_differ += int((ra != rb).any(-1).sum())
  differ = sum(per_layer)
  decisions = n_layers * SERVE_BATCH * SERVE_PROMPT * k
  dl = (res["prefill_logits"] - plain_res["prefill_logits"]).abs().max()
  agree = int((res["tokens"][:, 0] == plain_res["tokens"][:, 0]).sum())
  say(f"serve: kernel-path vs plain-path prefill: {differ} of {decisions} "
      f"routing decisions differ ({tokens_differ} token-layers); by layer "
      f"{per_layer}; last-position logits differ by at most "
      f"{float(dl):.3e}; first greedy token agrees in {agree} of "
      f"{SERVE_BATCH} rows")
  return res, launches, rec, worst


def gates_bound(logits: torch.Tensor, k: int, eps: float,
                st) -> tuple[float, str]:
  """Least time for the gates on these logits: bytes (logits in, gates
  out, f32) against operations at the f32 rate: the sort network's
  compare-exchanges (the row padded to 32, 64 or 128 slots, one operation
  each), one operation an element each for the scaling, y = s - w and the
  gate, and 4 a position the pool absorbs (add, count, divide, compare),
  counted from these rows' fit."""
  rows, e = logits.shape
  slots = 32 if e <= 32 else 64 if e <= 64 else 128
  stages = int(math.log2(slots)) * (int(math.log2(slots)) + 1) // 2
  z = logits.float() / eps
  s = torch.sort(z, dim=-1, descending=True, stable=True).values
  y = s - (torch.arange(e, device=z.device) < k).to(z.dtype)
  v = st.pool_at_k(y, k)
  blocks = rows + int((v[:, 1:] != v[:, :-1]).sum())
  n_ops = (rows * (slots // 2) * stages + 3 * rows * e
           + 4 * (rows * e - blocks))
  bytes_ms = rows * e * 8 / HBM_BYTES_PER_S * 1e3
  ops_ms = n_ops / F32_OPS_PER_S * 1e3
  return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def attn_bound(q, k, v, causal: bool) -> tuple[float, str]:
  """Least time for attention: bytes (q, k, v read once, out written once)
  against the tensor-core products (QK^T and PV over the unmasked pairs)
  plus the softmax (5 f32 ops a score) at the f32 rate."""
  b, sq, h, d = q.shape
  skv, dv = k.shape[1], v.shape[-1]
  pairs = (sum(min(i + 1, skv) for i in range(sq)) if causal else sq * skv)
  n_bytes = (q.numel() + k.numel() + v.numel() + b * sq * h * dv) * 2
  flops = 2 * b * h * pairs * (d + dv)
  bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
  ops_ms = (flops / BF16_OPS_PER_S + 5 * b * h * pairs / F32_OPS_PER_S) * 1e3
  return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


# torch.profiler on the card now and then records no device time in a
# session (CUPTI); a reading is taken again up to this many times, and if
# none shows device time it is reported as not measured.
PROFILER_TRIES = 3


def profile(fn, ranges=()) -> tuple[float, float | None,
                                    list[tuple[str, float, int]], dict]:
  """One call of ``fn`` under torch.profiler: (wall ms, device busy ms or
  None if no session recorded device time, every kernel with its device
  ms and launch count, the most device time first, and for each name in
  ``ranges`` (a
  ``record_function`` range) its host ms and its device span, from its
  first kernel's start to its last kernel's end, summed over its
  occurrences).  Busy time is the sum
  of the kernels' own device times (one stream: they do not overlap)."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile as torch_profile

  for _ in range(PROFILER_TRIES):
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
      t0 = time.perf_counter()
      fn()
      torch.cuda.synchronize()
      wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # The ranges (all named repro_...) also show as CUDA events spanning
    # their kernels: not kernels themselves.
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.key.startswith("repro_")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy > 0:
      top = sorted(kernels, key=lambda e: -e.self_device_time_total)
      spans = {name: [0.0, 0.0] for name in ranges}
      for e in events:
        if e.key in spans:
          cuda = e.device_type == DeviceType.CUDA
          spans[e.key][cuda] += (e.self_device_time_total if cuda
                                 else e.cpu_time_total) / 1e3
      return wall, busy, [(e.key, e.self_device_time_total / 1e3, e.count)
                          for e in top], spans
  return wall, None, [], {}


def kernel_device_ms(fn, name, calls: int = 20) -> float | None:
  """Device time per call of the CUDA kernels whose names contain
  ``name`` (or one of a tuple of names; ``""``: every kernel ``fn`` runs),
  from torch.profiler over ``calls`` calls of ``fn``: their own time,
  whatever the host spends around them.  None if no session recorded it."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile as torch_profile

  fn()
  names = (name,) if isinstance(name, str) else name
  for _ in range(PROFILER_TRIES):
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
      for _ in range(calls):
        fn()
      torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and any(n in e.key for n in names))
    if total > 0:
      return total / 1e3 / calls
  return None


def ms_text(ms: float | None) -> str:
  return "not measured" if ms is None else f"{ms:.4f} ms"


def share(bound_ms: float, ms: float | None) -> str:
  return "not measured" if ms is None else f"{bound_ms / ms:.1%}"


def serve_times(res, rec, serve, st, fa, name_limit):
  """Phase 5, serving: kernel, plain and library times at the path's own
  shapes, and the server's prefill ms and decode rate on a second run."""
  rows = {}
  lines = []
  cfg = res["cfg"]
  k = cfg.experts_per_token
  prefill_logits = rec.gates[0][0]
  decode_logits = rec.gates[-1][0]
  for logits in (prefill_logits, decode_logits):
    ms = median_ms(lambda: st.soft_topk_gates(logits, k, cfg.router_eps), 20)
    dev_ms = kernel_device_ms(
        lambda: st.soft_topk_gates(logits, k, cfg.router_eps),
        "soft_topk_kernel")
    plain_ms = median_ms(
        lambda: st.soft_topk_gates_plain(logits, k, cfg.router_eps), 3)
    bound_ms, bound_by = gates_bound(logits, k, cfg.router_eps, st)
    shape = tuple(logits.shape)
    if logits is prefill_logits:
      rows["soft_topk_gates"] = {"ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms, "bound_by": bound_by,
                                 "library_ms": None, "shape": list(shape)}
    lines.append(f"times: soft_topk_gates {shape} k {k}: kernel {ms:.4f} ms"
                 f" (device {ms_text(dev_ms)} a launch, profiler), plain "
                 f"{plain_ms:.3f} ms, bound {bound_ms:.3e} ms ({bound_by}) "
                 f"[{name_limit}]")
  q, kx, v, causal, _ = rec.attn[0]
  ms = median_ms(lambda: fa.flash_attention(q, kx, v, causal), 20)
  dev_ms = kernel_device_ms(lambda: fa.flash_attention(q, kx, v, causal),
                            "flash_kernel")
  plain_ms = median_ms(lambda: fa.flash_attention_plain(q, kx, v,
                                                        causal=causal), 5)
  qt, kt, vt = (t.transpose(1, 2) for t in (q, kx, v))

  def sdpa():
    torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=causal)

  lib_ms = median_ms(sdpa, 20)
  lib_dev_ms = kernel_device_ms(sdpa, "")   # every kernel of the call
  bound_ms, bound_by = attn_bound(q, kx, v, causal)
  rows["flash_attention"] = {"ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound_ms, "bound_by": bound_by,
                             "library_ms": lib_ms, "shape": list(q.shape)}
  lines.append(f"times: flash_attention q {tuple(q.shape)} v "
               f"{tuple(v.shape)} causal: kernel {ms:.4f} ms (device "
               f"{ms_text(dev_ms)} a launch, profiler), plain "
               f"{plain_ms:.4f} ms, scaled_dot_product_attention "
               f"{lib_ms:.4f} ms (device {ms_text(lib_dev_ms)}, profiler), "
               f"bound {bound_ms:.5f} ms ({bound_by}); the "
               f"bound is {share(bound_ms, ms)} of the kernel's time "
               f"({share(bound_ms, dev_ms)} of its device time) and "
               f"{share(bound_ms, lib_ms)} of SDPA's "
               f"({share(bound_ms, lib_dev_ms)} of its device time) "
               f"[{name_limit}]")
  prefill, decode, same = [], [], 0
  for _ in range(3):
    again = serve.generate(cfg, res["model"], res["prompts"], SERVE_GEN)
    same += int(torch.equal(again["tokens"], res["tokens"]))
    prefill.append(again["prefill_s"] * 1e3)
    decode.append((SERVE_GEN - 1) * SERVE_BATCH / again["decode_s"])
  lines.append(f"times: serve: {same} of 3 timed runs generated the first "
               "run's tokens")
  from repro_torch.launch import steps

  prompts, model = res["prompts"], res["model"]
  s = prompts.shape[1]
  state = {}

  def prefill_once():
    with torch.inference_mode():
      state["logits"], state["caches"] = steps.make_prefill_step(
          cfg, s + 2)(model, {"tokens": prompts})

  def decode_once():
    with torch.inference_mode():
      steps.make_decode_step(cfg)(model, state["caches"],
                                  serve.greedy(state["logits"]), s)

  for name, fn in (("prefill", prefill_once), ("decode step", decode_once)):
    wall, busy, top, _ = profile(fn)
    kernels = "; ".join(f"{key[:60]} {ms:.2f}" for key, ms, _ in top[:5])
    busy_text = ("not measured (no profiler session recorded device time)"
                 if busy is None else
                 f"{busy:.2f} ms ({100 * (1 - busy / wall):.0f}% idle)")
    lines.append(f"times: profile of one serve {name}: wall {wall:.2f} ms, "
                 f"device busy {busy_text}; most device time (ms): "
                 f"{kernels} [{name_limit}]")
  lines.append(f"times: serve {ARCH} prefill {SERVE_BATCH}x{SERVE_PROMPT} "
               f"{statistics.median(prefill):.2f} ms (runs "
               f"{', '.join(f'{t:.2f}' for t in prefill)}), decode "
               f"{statistics.median(decode):.1f} tok/s at batch {SERVE_BATCH}"
               f" (runs {', '.join(f'{t:.1f}' for t in decode)}) "
               f"[{name_limit}]")
  return rows, lines


# ---------------------------------------------------------------------------
# The training path (deepseek-v2-lite-16b at full width, 4 of 27 layers).
# ---------------------------------------------------------------------------

# Depth 4 of 27: the trainer keeps about 16 bytes a parameter (bf16
# weights and gradients, f32 AdamW moments, f32 gradient accumulators),
# about 260 GB at the full depth's 16.21e9 parameters and 44 GB at 4
# layers (2.76e9).  Width, grad_accum 8 and remat "full" are the config's.
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 8, 2048, 4
TRAIN_ARGS = ["--arch", ARCH, "--set", f"num_layers={TRAIN_LAYERS}",
              "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
              "--trim-frac", "0.1", "--corrupt", "0.1",
              "--steps", str(TRAIN_STEPS)]
EXPERT_LEAF = "layers.0.params.ffn.we_in"     # (64, 2048, 1408) bf16
TRAIN_RANGES = ("repro_forward_train", "repro_soft_lts_loss",
                "repro_optimizer_update")
# Kernel kinds of a train step's profile, by substrings of their names
# (the first group that matches); the rest is "other".
KERNEL_GROUPS = {
    "attention kernel": ("flash_kernel",),
    "PAV kernel": ("L2Algebra", "KlAlgebra"),
    "GEMM (cuBLAS nvjet)": ("nvjet",),
    "GEMM (other, f32 xmma among them)": ("gemm", "xmma"),
    "elementwise": ("elementwise",),
    "reductions and scans": ("reduce", "scan", "softmax", "norm"),
    "index, gather, scatter, sort": ("index", "gather", "scatter", "sort",
                                     "embedding", "Radix"),
    "copies": ("copy", "Memcpy", "Memset", "cat"),
    "other": (),
}


def train_launches_per_step(cfg) -> dict[str, int]:
  """Kernel launches of one train step, counted from the code: each of
  the ``grad_accum`` microbatches runs every layer's forward twice (remat
  "full": once, and again in backward), each pass launching attention
  once and ``pav_l2`` once (the router's ``soft_topk_mask`` over the
  microbatch's tokens, one row each, fewer than 65535); the soft-LTS loss
  sorts each microbatch's tokens in one more ``pav_l2`` launch.  The
  fused gates and ``pav_kl`` do not run under autograd."""
  passes = cfg.grad_accum * cfg.num_layers * (2 if cfg.remat == "full"
                                              else 1)
  trim = cfg.grad_accum if cfg.loss_trim_fraction > 0 else 0
  return {"pav_l2": passes + trim, "pav_kl": 0, "soft_topk_gates": 0,
          "flash_attention": passes}


class TrainRecorder:
  """Wraps, for the train run, the functions the train step calls through
  their modules, and calls through to each: ``steps.loss_from_batch`` (every
  microbatch's loss), ``adamw.update`` (the first step's gradients, finite
  and non-zero on every leaf or not; the launch counts at each step's end;
  each step's metrics; the last step's inputs and result on
  ``EXPERT_LEAF``), the attention wrapper (the first call's q, k, v) and
  the router's ``soft_topk_mask`` (the first call's logits)."""

  def __init__(self, ops, steps, adamw, fa, moe):
    self.ops, self.steps, self.adamw, self.fa, self.moe = (
        ops, steps, adamw, fa, moe)
    self.losses: list[float] = []
    self.grad_faults: list[str] | None = None
    self.n_leaves = 0
    self.step_launches: list[dict[str, int]] = []
    self.step_metrics: list[dict[str, float]] = []
    self.leaf: dict = {}
    self.attn: tuple | None = None
    self.logits: tuple | None = None

  def __enter__(self):
    self._orig = (self.steps.loss_from_batch, self.adamw.update,
                  self.fa.flash_attention, self.moe.soft_topk_mask)
    loss_fn, update, attn, mask = self._orig

    def loss_rec(cfg, model, batch):
      total, metrics = loss_fn(cfg, model, batch)
      self.losses.append(float(metrics["loss"].detach()))
      return total, metrics

    def update_rec(cfg, grads, state, params, lr_scale=1.0, decay=None):
      if self.grad_faults is None:
        self.n_leaves = len(grads)
        self.grad_faults = [
            n for n, g in grads.items()
            if not (bool(torch.isfinite(g).all()) and bool((g != 0).any()))]
      leaf = {"p": params[EXPERT_LEAF].detach().clone(),
              "g": grads[EXPERT_LEAF].clone(),
              "m": state["m"][EXPERT_LEAF].clone(),
              "v": state["v"][EXPERT_LEAF].clone(),
              "step": int(state["step"]) + 1, "lr_scale": lr_scale,
              "decay": True if decay is None else decay[EXPERT_LEAF],
              "cfg": cfg}
      out = update(cfg, grads, state, params, lr_scale, decay)
      leaf["after"] = params[EXPERT_LEAF].detach().clone()
      leaf["clip_scale"] = out[2]["clip_scale"]
      self.leaf = leaf
      self.step_metrics.append({k: float(v) for k, v in out[2].items()})
      torch.cuda.synchronize()
      self.step_launches.append(self.ops.all_launches())
      return out

    def attn_rec(q, k, v, causal=True, **opts):
      if self.attn is None:
        self.attn = (q.detach().clone(), k.detach().clone(),
                     v.detach().clone(), causal)
      return attn(q, k, v, causal, **opts)

    def mask_rec(values, k, *args, **kwargs):
      if self.logits is None:
        self.logits = (values.detach().clone(), k, args, kwargs)
      return mask(values, k, *args, **kwargs)

    (self.steps.loss_from_batch, self.adamw.update, self.fa.flash_attention,
     self.moe.soft_topk_mask) = loss_rec, update_rec, attn_rec, mask_rec
    return self

  def __exit__(self, *exc):
    (self.steps.loss_from_batch, self.adamw.update, self.fa.flash_attention,
     self.moe.soft_topk_mask) = self._orig


def train_path(dev, fa):
  """The train phase's run: ``launch/train.py``'s ``main`` with every
  counter from 0, then its checks.  Returns (main's result, recorder,
  launches)."""
  from repro_torch.kernels import ops
  from repro_torch.launch import steps, train
  from repro_torch.models import moe
  from repro_torch.optim import adamw

  ops.reset_all_launches()
  with TrainRecorder(ops, steps, adamw, fa, moe) as rec:
    res = train.main(TRAIN_ARGS)
  torch.cuda.synchronize()
  launches = ops.all_launches()
  cfg, state = res["cfg"], res["state"]
  check((cfg.num_layers, cfg.d_model, cfg.grad_accum, cfg.remat,
         cfg.dtype) == (TRAIN_LAYERS, 2048, 8, "full", "bfloat16"),
        f"train config {cfg}")
  check(state.step == TRAIN_STEPS == len(rec.step_launches),
        f"{state.step} steps taken, {len(rec.step_launches)} updates")
  per_step = train_launches_per_step(cfg)
  prev = dict.fromkeys(per_step, 0)
  for i, counts in enumerate(rec.step_launches):
    got = {k: counts[k] - prev[k] for k in per_step}
    check(got == per_step, f"train step {i}: launches {got}, counted from "
          f"the code {per_step}")
    prev = counts
  check(launches == {k: TRAIN_STEPS * n for k, n in per_step.items()},
        f"train launches {launches}")
  say(f"train: launches {launches} in {TRAIN_STEPS} steps, {per_step} a "
      f"step as counted from the code ({cfg.grad_accum} microbatches x "
      f"{cfg.num_layers} layers x 2 passes under remat, + "
      f"{cfg.grad_accum} soft-LTS sorts)")
  res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
  n_micro = TRAIN_STEPS * cfg.grad_accum
  check(len(rec.losses) == n_micro
        and all(math.isfinite(x) for x in rec.losses),
        f"train microbatch losses {rec.losses}")
  for i, m in enumerate(rec.step_metrics):
    check(all(math.isfinite(x) for x in m.values()),
          f"train step {i} metrics {m}")
  n_params = sum(1 for _ in state.model.parameters())
  check(rec.grad_faults == [] and rec.n_leaves == n_params,
        f"first step's gradients: {rec.n_leaves} leaves of {n_params}, "
        f"zero or not finite: {rec.grad_faults}")
  accum = cfg.grad_accum
  say("train: step losses " + ", ".join(
      f"{statistics.fmean(rec.losses[i * accum:(i + 1) * accum]):.4f}"
      for i in range(TRAIN_STEPS)) + "; grad norms " + ", ".join(
      f"{m['grad_norm']:.3f}" for m in rec.step_metrics) + " (all finite);"
      f" after step 1 all {n_params} parameter leaves had a finite, "
      "non-zero gradient")
  return res, rec, launches


def adamw_card_vs_cpu(rec, dev) -> str:
  """The last step's AdamW update of ``EXPERT_LEAF`` computed again by
  ``adamw.update_leaf`` on the card, with the step's scalars (clip scale,
  lr, bias corrections) as ``adamw.update`` computed them there (equal,
  after the cast, to what the trainer wrote), and on the CPU from the same
  inputs and scalars: the f32 results before the cast within one f32 ulp
  of each other.  (The scalars themselves come from ``pow`` on the card,
  which may round otherwise than the CPU's.)"""
  from repro_torch.optim import adamw

  leaf = rec.leaf
  cfg = leaf["cfg"]
  stepf = torch.tensor(leaf["step"], dtype=torch.float32, device=dev)
  scalars = (leaf["clip_scale"],
             cfg.lr * torch.as_tensor(leaf["lr_scale"], dtype=torch.float32,
                                      device=dev),
             1.0 - cfg.b1 ** stepf, 1.0 - cfg.b2 ** stepf)

  def on(device):
    return adamw.update_leaf(
        cfg, *(leaf[k].to(device) for k in ("p", "g", "m", "v")),
        *(x.to(device) for x in scalars), leaf["decay"])

  card = on(dev)
  check(torch.equal(card[0].to(leaf["after"].dtype), leaf["after"]),
        "the trainer's update of the expert leaf is not update_leaf's")
  card = [x.cpu() for x in card]
  cpu = on(torch.device("cpu"))
  parts = []
  for name, a, b in zip(("p", "m", "v"), card, cpu):
    ulp = torch.from_numpy(np.spacing(np.abs(b.numpy())))
    ratio = float(((a - b).abs() / ulp).max())
    check(ratio <= 1.0, f"AdamW {name}: card and CPU {ratio:.2f} ulp apart")
    parts.append(f"{name} {int((a != b).sum())} elements differ, at most "
                 f"{ratio:.2f} ulp")
  # Why update_leaf takes the square root in f64: the f32 one of the card
  # and of the CPU on the same v / bc2.
  vhat = ((leaf["v"] * cfg.b2) / scalars[3]).contiguous()
  f32_sqrt = int((torch.sqrt(vhat).cpu() != torch.sqrt(vhat.cpu())).sum())
  return (f"AdamW step {leaf['step']} of {EXPERT_LEAF} "
          f"{tuple(leaf['p'].shape)}, card vs CPU before the cast: "
          + "; ".join(parts) + " (limit 1 f32 ulp); an f32 torch.sqrt of "
          f"the leaf's b2 * v / bc2 differs between card and CPU in "
          f"{f32_sqrt} of {vhat.numel()} elements"
          "; update_leaf takes it in f64)")


def train_checks(rec, fa, dev) -> tuple[list[str], dict]:
  """Each piece of the train path on its captured inputs: the attention
  forward kernel and ``flash_attention_bwd`` by their error models, the
  router's ``soft_topk_mask`` fwd+bwd against the ``scan`` backend on the
  card, one AdamW update card against CPU.  Returns the lines and the
  tensors the times reuse."""
  import repro_torch as rt

  q, k, v, causal = rec.attn
  check(tuple(q.shape) == (1, TRAIN_SEQ, 16, 192)
        and tuple(v.shape) == (1, TRAIN_SEQ, 16, 128),
        f"captured attention shapes {q.shape}, {v.shape}")
  with torch.no_grad():
    out = fa.flash_attention(q, k, v, causal)
  fwd = attn_close(out, q, k, v, causal, fa)
  lines = [f"train: flash_attention forward on the captured layer inputs q "
           f"{tuple(q.shape)} v {tuple(v.shape)}: {attn_text(fwd, fa)}"]
  gen = torch.Generator(device=dev).manual_seed(SEED)
  do = torch.randn(out.shape, generator=gen, device=dev,
                   dtype=torch.bfloat16)
  grads = fa.flash_attention_bwd(q, k, v, out, do, causal)
  for name, cmp in fa.compare_bwd_with_plain(grads, q, k, v, do,
                                             causal).items():
    text = attn_text(cmp, fa, f"{name} - {name} of the plain version's "
                     "autograd in f32")
    check(cmp["finite"] and cmp["tol_ratio"] <= 1.0
          and cmp["rel_frob"] <= fa.REL_FROB_LIMIT,
          f"flash_attention_bwd {name}: {text}")
    lines.append(f"train: flash_attention_bwd {name}: {text}")

  logits, kk, args, kwargs = rec.logits
  x = logits.reshape(-1, logits.shape[-1])
  cot = torch.randn(x.shape, generator=gen, device=dev)
  got = {}
  for impl in (None, "scan"):
    xi = x.clone().requires_grad_(True)
    mask = rt.soft_topk_mask(xi, kk, *args, impl=impl, **kwargs)
    got[impl] = (mask.detach(), torch.autograd.grad(mask, xi, cot)[0])
  e_val = close(got[None][0], got["scan"][0])
  e_grad = close(got[None][1], got["scan"][1])
  lines.append(f"train: router soft_topk_mask fwd+bwd on the captured "
               f"logits {tuple(x.shape)} k {kk}, cuda backend vs scan on "
               f"the card: values {e_val:.3e}, gradients {e_grad:.3e} "
               "(tol 1e-5 * (1 + max|scan|))")
  lines.append("train: " + adamw_card_vs_cpu(rec, dev))
  return lines, {"qkv": (q, k, v), "out": out, "do": do}


def timed_steps(trainer, state, n: int) -> list[float]:
  """Seconds of ``n`` more train steps, timed as ``Trainer.run`` times
  them (a sync before, the loss read back after), with no recorder around
  the step's functions."""
  times = []
  for _ in range(n):
    batch = trainer.batch_at(state.step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, state.opt_state, metrics = trainer.train_step(
        state.model, state.opt_state, batch)
    loss = float(metrics["loss"])
    times.append(time.perf_counter() - t0)
    check(math.isfinite(loss), f"train step {state.step} loss {loss}")
    state.step += 1
  return times


def sliced_sqrt_rn(x, sqrt_rn, n: int) -> torch.Tensor:
  """``sqrt_rn`` over slices of ``n`` elements, so that each slice's f64
  copy could stay in L2 (a yardstick, not used by the trainer)."""
  out = torch.empty_like(x)
  for xs, os in zip(x.view(-1).split(n), out.view(-1).split(n)):
    os.copy_(sqrt_rn(xs))
  return out


def optimizer_times(trainer, state, name_limit) -> str:
  """``adamw.update`` over the trainer's whole state with random bf16
  gradients (CUDA-event medians), with each square root in turn:
  ``sqrt_rn`` (the trainer's), PyTorch's f32 ``torch.sqrt`` (not correctly
  rounded on the card) and the f64 round trip in three passes, then
  ``sqrt_rn`` again; and each square root alone on ``EXPERT_LEAF``, also
  ``sqrt_rn`` in slices."""
  from repro_torch.models import transformer as T
  from repro_torch.optim import adamw

  dev = trainer.device
  params = dict(state.model.named_parameters())
  gen = torch.Generator(device=dev).manual_seed(SEED)
  grads = {n: torch.randn(p.shape, generator=gen, device=dev,
                          dtype=p.dtype) for n, p in params.items()}
  cfg, decay = trainer.opt_cfg, T.decay_mask(state.model)
  adam = state.opt_state["adam"]
  roots = {"sqrt_rn": adamw.sqrt_rn, "f32 torch.sqrt": torch.sqrt,
           "f64 round trip": lambda x: torch.sqrt(
               x.to(torch.float64)).to(torch.float32),
           "sqrt_rn in 2^22-element slices": lambda x: sliced_sqrt_rn(
               x, adamw.sqrt_rn, 1 << 22)}
  runs = []
  try:
    for name in ("sqrt_rn", "f32 torch.sqrt", "f64 round trip", "sqrt_rn"):
      adamw.sqrt_rn = roots[name]
      ms = median_ms(lambda: adamw.update(cfg, grads, adam, params, 1.0,
                                          decay), 3)
      runs.append(f"{name} {ms:.1f}")
  finally:
    adamw.sqrt_rn = roots["sqrt_rn"]
  del grads
  x = adam["v"][EXPERT_LEAF].float().abs()
  alone = ", ".join(f"{name} {median_ms(lambda: fn(x), 10):.3f}"
                    for name, fn in roots.items())
  n = sum(p.numel() for p in params.values())
  dtype = str(next(iter(params.values())).dtype).removeprefix("torch.")
  return (f"times: adamw.update of all {len(params)} leaves ({n:,} "
          f"parameters, {dtype} gradients) by square root, in this order "
          f"(ms):"
          f" {'; '.join(runs)}; the square root alone on {EXPERT_LEAF} "
          f"{tuple(x.shape)} f32 (ms): {alone} [{name_limit}]")


def train_times(res, rec, captured, fa, name_limit) -> list[str]:
  """Step ms (median of 3 steps after the recorded run), tokens/s, peak
  memory; the attention forward and backward at the training shape beside
  SDPA's; one more step under the profiler; the optimizer by square
  root."""
  lines = []
  trainer, state = res["trainer"], res["state"]
  dev = trainer.device
  recorded = trainer.step_times
  rec.leaf = {}     # the recorder's copies of the expert leaf (2.6 GB)
  torch.cuda.reset_peak_memory_stats(dev)
  times = timed_steps(trainer, state, 3)
  peak = torch.cuda.max_memory_allocated(dev) / 2**30
  med = statistics.median(times) * 1e3
  tokens = TRAIN_BATCH * TRAIN_SEQ
  lines.append(
      f"times: train {ARCH} {TRAIN_LAYERS} of 27 layers, batch "
      f"{TRAIN_BATCH} x {TRAIN_SEQ}, grad_accum 8, remat full: step "
      f"{med:.1f} ms (median of 3 steps after the recorded run, no "
      f"recorder: {', '.join(f'{t * 1e3:.1f}' for t in times)}), "
      f"{tokens / med * 1e3:.0f} tokens/s; the recorded run's steps 1-"
      f"{TRAIN_STEPS}, with the recorder's syncs and clones: "
      f"{', '.join(f'{t * 1e3:.1f}' for t in recorded)} (median of steps "
      f"2-{TRAIN_STEPS} {statistics.median(recorded[1:]) * 1e3:.1f}, "
      f"{tokens / statistics.median(recorded[1:]):.0f} tokens/s); peak memory "
      f"{peak:.2f} GiB ({res['peak_gib']:.2f} in the recorded run) "
      f"[{name_limit}]")
  q, k, v = captured["qkv"]
  out, do = captured["out"], captured["do"]
  fwd_ms = median_ms(lambda: fa.flash_attention(q, k, v, True), 20)
  fwd_dev = kernel_device_ms(lambda: fa.flash_attention(q, k, v, True),
                             "flash_kernel")
  bwd = lambda: fa.flash_attention_bwd(q, k, v, out, do, True)  # noqa: E731
  bwd_ms = median_ms(bwd, 10)
  bwd_dev = kernel_device_ms(bwd, "", calls=5)
  qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                for t in (q, k, v))
  dot = do.transpose(1, 2)
  sdpa = torch.nn.functional.scaled_dot_product_attention

  def sdpa_fwd():
    with torch.no_grad():
      sdpa(qt, kt, vt, is_causal=True)

  def sdpa_fwd_bwd():
    torch.autograd.grad(sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt), dot)

  lib_fwd = median_ms(sdpa_fwd, 20)
  lib_fb = median_ms(sdpa_fwd_bwd, 10)
  lib_fb_dev = kernel_device_ms(sdpa_fwd_bwd, "", calls=5)
  bound_ms, bound_by = attn_bound(q, k, v, True)
  lines.append(
      f"times: train attention q {tuple(q.shape)} v {tuple(v.shape)} "
      f"causal: kernel forward {fwd_ms:.4f} ms (device {ms_text(fwd_dev)}, "
      f"profiler), bound {bound_ms:.5f} ms ({bound_by}); "
      f"flash_attention_bwd {bwd_ms:.3f} ms (device {ms_text(bwd_dev)}, "
      f"all its kernels); scaled_dot_product_attention forward "
      f"{lib_fwd:.4f} ms, forward + backward {lib_fb:.4f} ms (device "
      f"{ms_text(lib_fb_dev)}), so its backward about "
      f"{lib_fb - lib_fwd:.4f} ms [{name_limit}]")

  batch = trainer.batch_at(state.step)
  wall, busy, top, spans = profile(
      lambda: trainer.train_step(state.model, state.opt_state, batch),
      TRAIN_RANGES)
  kernels = "; ".join(f"{key[:60]} {ms:.1f}" for key, ms, _ in top[:5])
  groups = dict.fromkeys(KERNEL_GROUPS, 0.0)
  for key, ms, _ in top:
    groups[next((g for g, pats in KERNEL_GROUPS.items()
                 if any(p in key for p in pats)), "other")] += ms
  group_text = ", ".join(f"{g} {ms:.1f}" for g, ms in groups.items())
  launches = sum(n for _, _, n in top)
  busy_text = ("not measured (no profiler session recorded device time)"
               if busy is None else
               f"{busy:.1f} ms ({100 * (1 - busy / wall):.0f}% idle) in "
               f"{launches} kernel launches; by kind (ms): {group_text}")
  span_text = "; ".join(f"{name} host {cpu:.1f} ms, device span "
                        f"{dev_ms:.1f} ms" for name, (cpu, dev_ms) in
                        spans.items())
  lines.append(f"times: profile of one train step: wall {wall:.1f} ms, "
               f"device busy {busy_text}; ranges (summed over the "
               f"microbatches): {span_text}; most device time (ms): "
               f"{kernels} [{name_limit}]")
  lines.append(optimizer_times(trainer, state, name_limit))
  return lines


def main() -> int:
  # 1. device ---------------------------------------------------------------
  if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: CUDA is not available\n")
    return 2
  sys.path.insert(0, str(ROOT / "src"))
  import repro_torch as rt
  from repro_torch.kernels import _build, ops as kops, pav, pav_scan
  from repro_torch.kernels import segment_vjp
  from repro_torch.kernels import flash_attention as fa
  from repro_torch.kernels import soft_topk as st
  from repro_torch.launch import serve

  dev = torch.device("cuda", 0)
  torch.cuda.set_device(dev)
  # f32 products in full f32 (the default, stated): the router logits and
  # the f32 comparisons below.
  torch.backends.cuda.matmul.allow_tf32 = False
  name_limit = card()
  say(name_limit)
  say(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
      f"on {torch.cuda.get_device_name(0)}")

  # 2. build ----------------------------------------------------------------
  t0 = time.perf_counter()
  libs = _build.build_all()
  say(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s; by "
      "source (nvcc start to exit, all in parallel): " + ", ".join(
          f"{name} {sec:.2f} s" for name, sec in
          sorted(_build.BUILD_SECONDS.items())))
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
  # The PAV kernels are held against their plain versions pav_l2_scan /
  # pav_kl_scan and within the contract against the stack machine, kept
  # apart.
  max_err = {"pav_l2": 0.0, "pav_l2 vs stack": 0.0, "pav_kl": 0.0,
             "pav_kl vs stack": 0.0, "soft_topk_gates": 0.0,
             "flash_attention": 0.0}

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
        errs.append(record(f"{kname} vs stack", out,
                           getattr(pav, f"{kname}_stack")(*args)))
      say(f"kernels: ({rows}, {n}) {kind}: max |kernel - plain| on the card"
          f" l2 {errs[0]:.3e} kl {errs[1]:.3e} (tol 1e-5 * (1 + max|plain|))")

  serve_kernel_checks(rng, dev, st, fa, record, max_err)

  # At (128, 10000) and (1, 2**20) the stack machine takes tens of seconds
  # per call: it runs on a CPU copy in worker processes (spawned, so they
  # never touch CUDA), the longest first (the adversarial rows' plain
  # divide and conquer, put first by pav_scan_checks), while phase 4 runs
  # on the card.  Job: (kernel, what, shape, kernel output, plain function,
  # inputs).
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
        jobs.append((kname, f"{kind} input, plain stack machine", (rows, n),
                     out, f"{kname}_stack",
                     tuple(a.cpu().numpy() for a in args)))
  pav_scan_checks(rng, dev, pav, pav_scan, theta_np, tokens_np, record, jobs)

  pool = ProcessPoolExecutor(max_workers=CPU_WORKERS,
                             mp_context=multiprocessing.get_context("spawn"))
  try:
    futures = [pool.submit(plain_on_cpu, job[4], job[5]) for job in jobs]
    token_future = pool.submit(token_loss_on_cpu, tokens_np)
    say(f"kernels: {len(jobs)} comparisons at (1, {TOKENS}) and (128, 10000)"
        f" and the token loss on the CPU handed to {CPU_WORKERS} CPU worker "
        "processes")

    # 4. main path ------------------------------------------------------------
    launches, token_run = main_path(rt, pav, dev, theta_np, target_np,
                                    cot_np, tokens_np)
    # The serving path runs on the card while the CPU workers finish.
    serve_res, serve_launches, serve_rec, serve_err = serve_path(
        dev, serve, kops, st, fa)
    for kname, err in serve_err.items():
      max_err[kname] = max(max_err[kname], err)

    t0 = time.perf_counter()
    for (kname, what, shape, out, fn_name, _), future in zip(jobs, futures):
      ref, seconds = future.result()
      stack = fn_name.endswith("_stack")
      # Bit for bit: the l2 divide and conquer (adds round alike on CPU
      # and card).  Blocks: every comparison but l2's with the stack
      # machine, whose sums of 1e4 values differ in the last bits.
      reason = ("the stack machine pools in another order" if stack
                else KL_ON_CPU if kname == "pav_kl" else None)
      text = hold(f"{kname} vs stack" if stack else kname,
                  f"{shape} {what}", out, torch.from_numpy(ref), record,
                  reason, blocks=kname == "pav_kl" or not stack)
      say(f"kernels: {kname} {shape} {what}, on a CPU copy: {text}; plain "
          f"{seconds:.1f} s on one CPU core")
    (ref_out, ref_grad), seconds = token_future.result()
    e_out = close(token_run[0], torch.from_numpy(ref_out))
    e_grad = close(token_run[1], torch.from_numpy(ref_grad))
    say(f"main: soft_trimmed_token_loss ({TOKENS},) card vs CPU port: value "
        f"{e_out:.3e}, gradients {e_grad:.3e} (tol 1e-5 * (1 + max|CPU|); "
        f"CPU {seconds:.1f} s)")
    say(f"kernels: waited {time.perf_counter() - t0:.1f} s for the CPU "
        "workers after phase 4")
    for kname in ("pav_l2", "pav_kl"):
      say(f"kernels: {kname} worst |kernel - plain divide and conquer| "
          f"{max_err[kname]:.3e}, worst |kernel - stack machine| "
          f"{max_err[kname + ' vs stack']:.3e} (both within 1e-5 * (1 + "
          "max|plain|))")
  finally:
    pool.shutdown(wait=True, cancel_futures=True)

  # 5. times -------------------------------------------------------------------
  lines = []
  kernel_rows = {}
  plain_fns = {"pav_l2": pav_scan.pav_l2_scan, "pav_kl": pav_scan.pav_kl_scan}
  for rows, n in KERNEL_SHAPES:
    if rows == 1:
      s, w = main_solver_inputs(None, to_dev(tokens_np, dev))
      theta = to_dev(tokens_np.reshape(1, -1), dev)
    else:
      theta = to_dev(theta_np[(rows, n)], dev)
      s, w = main_solver_inputs(theta, None)
    _, (rs, rw) = solver_inputs(rng, rows, n, "random")
    rs, rw = to_dev(rs, dev), to_dev(rw, dev)
    ramps = to_dev(two_ramps(rows, n), dev)
    inputs = {("pav_l2", "main"): ((s - w).contiguous(),),
              ("pav_kl", "main"): (s, w),
              ("pav_l2", "random"): (rs - rw,),
              ("pav_kl", "random"): (rs, rw),
              ("pav_l2", "adversarial"): (ramps,),
              ("pav_kl", "adversarial"): (ramps, torch.zeros_like(ramps))}
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
      dev_text = ""
      if kind == "main":
        dev_ms = kernel_device_ms(lambda: kernel(*args), DEVICE_NAMES[kname],
                                  reps)
        dev_text = f" (device {ms_text(dev_ms)}, profiler)"
      plain_ms = None
      if kind == "main":
        plain = plain_fns[kname]
        plain_ms = median_ms(lambda: plain(*args), 1, warmup=0)
      if kind == "main":
        kernel_rows[(kname, (rows, n))] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}
      plain_text = ("not measured" if plain_ms is None
                    else f"{plain_ms:.1f} ms ({plain_fns[kname].__name__})")
      lines.append(f"times: {kname} ({rows}, {n}) {kind} input: kernel "
                   f"{ms:.4f} ms{dev_text}, plain {plain_text}, bound "
                   f"{bound_ms:.5f} ms"
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
  serve_rows, serve_lines = serve_times(serve_res, serve_rec, serve, st, fa,
                                        name_limit)
  for line in lines + serve_lines:
    say(line)

  # 6. train ------------------------------------------------------------------
  # The server's 27-layer model (30.2 GiB) goes before the trainer's state.
  del serve_res, serve_rec
  gc.collect()
  torch.cuda.empty_cache()
  say(f"train: the server's model freed; "
      f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB still allocated")
  train_res, train_rec, train_launches = train_path(dev, fa)
  train_lines, captured = train_checks(train_rec, fa, dev)
  for line in train_lines + train_times(train_res, train_rec, captured, fa,
                                        name_limit):
    say(line)

  # 7. summary -------------------------------------------------------------
  kernels = []
  for kname in ("pav_l2", "pav_kl"):
    row = kernel_rows[(kname, HEADLINE)]
    kernels.append({
        "name": kname, "route": "cuda", "source": SOURCES[kname],
        "replaces": REPLACES[kname], "launches": launches[kname],
        "max_abs_err": max_err[kname], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None,
        "shape": list(HEADLINE), "train_launches": train_launches[kname]})
  for kname, row in serve_rows.items():
    kernels.append({
        "name": kname, "route": "cuda", "source": SOURCES[kname],
        "replaces": REPLACES[kname], "launches": serve_launches[kname],
        "max_abs_err": max_err[kname], **row,
        "train_launches": train_launches[kname]})
  say(json.dumps({"kernels": kernels}))
  say(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
