"""The traced segment: a padded torch.profiler session and one pass over it.

A copy of ``chip_smoke.py``'s ``padded_profile`` / ``read_profile`` /
``unrecorded`` (the repository's proof script), kept here so that later
changes to the program cannot move the yardstick.  CUPTI loses the first
2 to 6 kernel launches of a session once other processes have come and
gone, so each session opens with ``PAD`` launches of the pad kernel
(``torch.cuda._sleep``'s ``spin_kernel``) for the loss to take, and a
reading counts only where the session recorded every launch of the port's
kernels that their wrappers counted (``Trace.short``); otherwise the
readings that rest on kernel times are reported missing, never low.

One pass over the raw events (``kineto_results.events()``; torch's own
``key_averages`` takes minutes over 10^5 launches) gives: each kernel's
device time and count, the device's busy intervals (kernels, copies,
sets), the kernels launched inside each ``repro_*`` range (a kernel
belongs to the host op whose correlation id it links to, and so to the
ranges on that op's thread that were open when the op started), and the
device's idle gaps, each named by the innermost host op that launched the
kernel ending it.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

import torch

PAD = 16
PAD_KERNEL = "spin_kernel"
TRIES = 3

# The CUDA kernel each port kernel's wrapper launches first, once a launch,
# as the profiler names it (every part in the name).
FIRST_KERNELS = {"pav_l2": ("tile_kernel", "L2Algebra"),
                 "pav_kl": ("tile_kernel", "KlAlgebra"),
                 "soft_topk_gates": ("soft_topk_kernel",),
                 "flash_attention": ("flash_kernel",),
                 "flash_attention_simt": ("attention_simt",)}


@dataclasses.dataclass
class Trace:
  """What a traced segment showed.  Times in seconds."""
  window_s: float
  busy_s: float
  kernels: dict            # name -> [seconds, launches]
  ranges: dict             # range name -> {kernel name: [seconds, launches]}
  gaps: dict               # host op name -> idle seconds before its kernels
  units: int               # steps or requests the segment ran
  short: str               # "" or which port kernels lost launches

  def kernel_seconds(self, *parts: str) -> tuple[float, int]:
    """Seconds and launches of the kernels whose names hold every part."""
    s, n = 0.0, 0
    for name, (sec, cnt) in self.kernels.items():
      if all(p in name for p in parts):
        s += sec
        n += cnt
    return s, n

  def range_seconds(self, *prefixes: str) -> float:
    """Device seconds of the kernels launched inside any range whose name
    starts with one of ``prefixes``, each kernel counted once."""
    total = 0.0
    seen = set()
    for rname, kern in self.ranges.items():
      if rname.startswith(prefixes):
        for key, (sec, _) in kern.items():
          if key not in seen:
            seen.add(key)
            total += sec
    return total

  def breakdown(self) -> dict:
    ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], s] for n, (s, _) in ops],
            "idle_gaps": [[n[:120], s] for n, s in gaps]}


@contextlib.contextmanager
def padded_profile():
  from torch.profiler import ProfilerActivity, profile

  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    for _ in range(PAD):
      torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    yield prof
    torch.cuda.synchronize()


def unrecorded(kernels: dict, launched: dict) -> str:
  short = []
  for kname, want in launched.items():
    if kname not in FIRST_KERNELS or want == 0:
      continue
    parts = FIRST_KERNELS[kname]
    got = sum(n for name, (_, n) in kernels.items()
              if all(p in name for p in parts))
    if got != want:
      short.append(f"{kname} {got} of {want}")
  return ", ".join(short)


def read(prof) -> tuple:
  """(kernels, ranges, busy seconds, gaps) of a finished session."""
  from torch.autograd import DeviceType

  kernels: dict = {}
  device = []          # (start ns, end ns, linked correlation id)
  launch_op = {}       # correlation id -> (thread, start ns)
  ops = {}             # thread -> [(start, end, name)] host ops
  range_windows = []   # (thread, start, end, name)
  for e in prof.profiler.kineto_results.events():
    name = e.name()
    if e.device_type() == DeviceType.CUDA:
      if name.startswith("repro_") or PAD_KERNEL in name:
        continue
      ns = e.duration_ns()
      k = kernels.setdefault(name, [0.0, 0])
      k[0] += ns / 1e9
      k[1] += 1
      device.append((e.start_ns(), e.start_ns() + ns,
                     e.linked_correlation_id(), name))
      continue
    if e.linked_correlation_id() != 0:
      continue
    tid, lo = e.start_thread_id(), e.start_ns()
    hi = lo + e.duration_ns()
    launch_op[e.correlation_id()] = (tid, lo)
    if name.startswith("repro_"):
      range_windows.append((tid, lo, hi, name))
    elif not name.startswith(("cuda", "cu")):
      ops.setdefault(tid, []).append((lo, hi, name))
  device.sort()
  busy = 0.0
  end = None
  gaps: dict = {}
  for lo, hi, _, _ in device:
    if end is None or lo >= end:
      busy += (hi - lo) / 1e9
      end = hi
    elif hi > end:
      busy += (hi - end) / 1e9
      end = hi
  for tid in ops:
    ops[tid].sort()
  starts = {tid: [o[0] for o in lst] for tid, lst in ops.items()}

  def innermost(tid, t):
    lst = ops.get(tid)
    if not lst:
      return "unattributed"
    i = bisect.bisect_right(starts[tid], t) - 1
    best = None
    for j in range(i, max(i - 64, -1), -1):
      lo, hi, name = lst[j]
      if lo <= t <= hi and (best is None or hi - lo < best[0]):
        best = (hi - lo, name)
    return best[1] if best else "unattributed"

  prev_end = None
  by_thread: dict = {}
  for idx, (lo, hi, corr, name) in enumerate(device):
    op = launch_op.get(corr)
    if prev_end is not None and lo > prev_end:
      who = innermost(*op) if op else "unattributed"
      gaps[who] = gaps.get(who, 0.0) + (lo - prev_end) / 1e9
    prev_end = hi if prev_end is None else max(prev_end, hi)
    if op is not None:
      by_thread.setdefault(op[0], []).append((op[1], idx))
  # Sweep each thread's launches in time order against its ranges.
  ranges: dict = {}
  windows: dict = {}
  for rtid, rlo, rhi, rname in range_windows:
    windows.setdefault(rtid, []).append((rlo, rhi, rname))
  for tid, launches in by_thread.items():
    wins = sorted(windows.get(tid, []))
    launches.sort()
    nxt, active = 0, []
    for t, idx in launches:
      while nxt < len(wins) and wins[nxt][0] <= t:
        active.append(wins[nxt])
        nxt += 1
      active = [w for w in active if w[1] >= t]
      lo, hi, _, name = device[idx]
      for _, _, rname in active:
        ranges.setdefault(rname, {})[(idx, name)] = [(hi - lo) / 1e9, 1]
  return kernels, ranges, busy, gaps


def traced(run, units: int) -> Trace:
  """Run ``run()`` (the segment's work; it ends synchronised) under a
  padded session, up to ``TRIES`` times until one records every launch of
  the port's kernels; the last try's reading otherwise, marked short."""
  from repro_torch.kernels import ops as kops

  trace = None
  for _ in range(TRIES):
    with padded_profile() as prof:
      before = kops.all_launches()
      t0 = time.perf_counter()
      run()
      torch.cuda.synchronize()
      window = time.perf_counter() - t0
      launched = {k: n - before.get(k, 0)
                  for k, n in kops.all_launches().items()}
    kernels, ranges, busy, gaps = read(prof)
    short = unrecorded(kernels, launched) if busy > 0 else "no device time"
    trace = Trace(window, busy, kernels, ranges, gaps, units, short)
    if not short:
      break
  return trace
