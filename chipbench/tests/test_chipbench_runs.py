"""Whole runs at smoke size on the CPU: the result line's schema, the
modules a run loads, the control, and the faults a cell can have planted
underneath the timed path, each of which has to make ``correct`` false."""

from __future__ import annotations

import ast
import json

import pytest
import torch

from chipbench import run as R
from chipbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_result_line_schema(cell):
  line = tiny.run(tiny.env(cell))
  assert list(line) == KEYS
  assert isinstance(line["correct"], bool) and line["attempted"] > 0
  assert line["failed"] == 0
  json.dumps(line)
  # The CPU has no CUDA events: the device-timed tails are the card's.
  want = {m["name"] for m in R.metric_specs("end_to_end")
          if cell in m.get("workloads", [cell])
          and m["source"] == "host_clock"}
  assert set(line["metrics"]) == want
  for m in line["metrics"].values():
    assert set(m) == {"value", "unit"} and m["value"] > 0
  assert set(line["device"]) == {"platform", "kind", "count",
                                 "memory_peak_bytes"}
  assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
  assert R.forbidden_modules() == []


def _imports(path):
  tree = ast.parse(path.read_text())
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
      yield node.module


def test_no_module_imports_jax_or_the_jax_package():
  for path in R.BENCH.rglob("*.py"):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(R.FORBIDDEN), path
    if "reference" in path.parts:
      assert "repro_torch" not in tops, path


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_is_not_correct(cell):
  """The reference in float8, put in the program's place, fails a limit."""
  env = tiny.env(cell, seed=3)
  c = R.cell_class(env)(env)
  c.setup()
  c.window(0.2)
  c.release()
  if env.traffic["kind"] == "train":
    from chipbench.reference import model as M
    got = c.compare(c.reference(M.FP8), c.reference(M.F32))
  else:
    got = c.readings(control=True)["control"]
  assert any(got[k] > limit for k, limit in env.limits.items()), got


def _broken_train(monkeypatch, how):
  from repro_torch.launch import steps as ST
  real = ST.make_train_step

  def make(cfg, opt_cfg, **kw):
    if how == "half_batch":
      import dataclasses
      half = dataclasses.replace(cfg, grad_accum=max(1, cfg.grad_accum // 2))
      step = real(half, opt_cfg, **kw)
      return lambda model, opt, batch: step(
          model, opt, {k: v[:v.shape[0] // 2] for k, v in batch.items()})

    def unchanged(model, opt, batch):
      with torch.no_grad():
        loss, metrics = ST.loss_from_batch(cfg, model, batch)
      return model, opt, metrics
    return unchanged
  monkeypatch.setattr(ST, "make_train_step", make)


def _broken_serving(monkeypatch, how):
  from repro_torch.launch import steps as ST
  real_decode, real_prefill = ST.make_decode_step, ST.make_prefill_step

  def alter(logits):
    out = logits.clone()
    out[0] = torch.roll(logits[0], 1, dims=-1)
    return out

  def make_decode(cfg):
    step = real_decode(cfg)

    def decode(model, caches, tok, pos):
      if how == "unchanged":
        kept = [{k: v[:, pos].clone() for k, v in c.items()} for c in caches]
        logits, caches = step(model, caches, tok, pos)
        for c, k in zip(caches, kept):
          for name, v in k.items():
            c[name][:, pos] = v
        return logits, caches
      if how == "half_batch":
        h = tok.shape[0] // 2
        part = [{k: v[:h] for k, v in c.items()} for c in caches]
        logits, _ = step(model, part, tok[:h], pos)
        return torch.cat([logits, logits]), caches
      logits, caches = step(model, caches, tok, pos)
      return alter(logits), caches
    return decode

  def make_prefill(cfg, max_len=None):
    step = real_prefill(cfg, max_len)

    def prefill(model, batch):
      logits, caches = step(model, batch)
      return (alter(logits) if how == "altered" else logits), caches
    return prefill
  monkeypatch.setattr(ST, "make_decode_step", make_decode)
  monkeypatch.setattr(ST, "make_prefill_step", make_prefill)


# The faults each cell can have (none is across chips: every cell is on one).
FAULTS = [("dsv2l4.train-lts", "unchanged"), ("dsv2l4.train-lts", "half_batch"),
          ("grok1l6.decode-32x2k", "unchanged"),
          ("grok1l6.decode-32x2k", "half_batch"),
          ("grok1l6.decode-32x2k", "altered"),
          ("grok1l6.prefill-1x512-4k", "altered"),
          ("grok1l6.prefill-1x512-4k", "longest_only")]


def _broken_attention(monkeypatch, start):
  """The attention kernel wrong from position ``start`` on: each query
  row there gets the row before it (an off-by-one in the output's rows)."""
  from repro_torch.kernels import flash_attention as FA
  real = FA.flash_attention

  def attention(q, k, v, *args, **kw):
    o = real(q, k, v, *args, **kw)
    if o.shape[1] <= start:
      return o
    o = o.clone()
    o[:, start:] = o[:, start - 1:-1].clone()
    return o
  monkeypatch.setattr(FA, "flash_attention", attention)


@pytest.mark.parametrize("cell,how", FAULTS)
def test_fault_is_not_correct(monkeypatch, cell, how):
  env = tiny.env(cell, seed=4)
  if env.traffic["kind"] == "train":
    _broken_train(monkeypatch, how)
  elif how == "longest_only":
    # Only the longest prompts reach the fault: a reading that every
    # checked request and token feeds has to fail it all the same.
    from chipbench.traffic.prefill import lengths
    _broken_attention(monkeypatch, sorted(set(lengths(env.traffic)))[-2])
  else:
    _broken_serving(monkeypatch, how)
  line = tiny.run(env)
  assert line["correct"] is False, line["checks"]


def test_forbidden_module_loaded_by_the_reference_stops_the_run(monkeypatch):
  """The look for JAX comes after the reference has run: a module that the
  reference loads stops the run before a result is printed."""
  import sys
  import types
  env = tiny.env("grok1l6.prefill-1x512-4k", seed=2)
  real = R.cell_class(env)

  class Loads(real):
    def readings(self, control=False):
      monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
      return super().readings(control)
  monkeypatch.setattr(R, "cell_class", lambda env: Loads)
  with pytest.raises(SystemExit) as stop:
    tiny.run(env)
  assert stop.value.code == 3
