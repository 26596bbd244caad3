"""Arithmetic shared by the per-layer readers in ``metrics/``.

A reader takes the run's facts (what its traffic counted and the
yardstick's least times) and the traced segment's reading, and returns
its number or None: None where the trace recorded fewer launches of the
port's kernels than their wrappers counted (``Trace.short``), where the
segment ran none of the kernels it reads, or where the cell is not of its
kind.  A share of a roofline or a peak is never reported as 0.
"""

from __future__ import annotations

from chipbench import yardstick as Y


def idle_pct(facts: dict, trace, kind: str):
  if facts["kind"] != kind or trace is None or trace.short:
    return None
  return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def busy_ms(facts: dict, trace, kind: str):
  """Device ms a traced unit in which an operation ran on the card."""
  if facts["kind"] != kind or trace is None or trace.short:
    return None
  return 1e3 * trace.busy_s / trace.units


def range_ms(facts: dict, trace, kind: str, *prefixes: str):
  """Device ms a traced step of the kernels launched inside the ranges."""
  if facts["kind"] != kind or trace is None or trace.short:
    return None
  s = trace.range_seconds(*prefixes)
  return 1e3 * s / trace.units if s > 0 else None


def flash_roofline_pct(facts: dict, trace, kind: str):
  """The attention kernel's least time over its device time, over every
  launch of the traced segment (``facts["flash_launch_s"]`` holds the
  least time of each launch of one unit, or of every unit for prefill)."""
  if facts["kind"] != kind or trace is None or trace.short:
    return None
  least = facts["flash_launch_s"]
  if kind == "train":
    least = least * trace.units
  got_s, launches = trace.kernel_seconds("flash_kernel")
  if launches != len(least) or got_s <= 0:
    return None
  return 100.0 * sum(least) / got_s


def peak_share_pct(facts: dict, kind: str):
  """The whole window's share of the card's bf16 peak (train, prefill) or
  of the step's roofline (decode: the larger of FLOPs and bytes)."""
  if facts["kind"] != kind or facts["window_s"] <= 0:
    return None
  if kind == "train":
    flops = facts["step_flops"] * facts["window_steps"]
    return 100.0 * flops / (facts["window_s"] * Y.BF16_FLOPS)
  if kind == "prefill":
    return 100.0 * facts["flops"] / (facts["window_s"] * Y.BF16_FLOPS)
  return 100.0 * facts["least_s"] / facts["window_s"]
