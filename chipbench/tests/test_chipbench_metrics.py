"""The traced segment's reading and the per-layer arithmetic, on a
synthetic profiler trace; the yardstick's counts against hand sums."""

from __future__ import annotations

import types

import pytest
import torch
from torch.autograd import DeviceType

from chipbench import profiling as P
from chipbench import readers
from chipbench import run as R
from chipbench import weights as W
from chipbench import yardstick as Y
from chipbench.tests import tiny  # noqa: F401  (the checkout's src/ on the path)


def event(name, start, dur, corr=0, linked=0, device=False, tid=1):
  return types.SimpleNamespace(
      name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
      correlation_id=lambda: corr, linked_correlation_id=lambda: linked,
      start_thread_id=lambda: tid,
      device_type=lambda: DeviceType.CUDA if device else DeviceType.CPU)


def profile_of(events):
  results = types.SimpleNamespace(events=lambda: events)
  return types.SimpleNamespace(
      profiler=types.SimpleNamespace(kineto_results=results))


EVENTS = [
    event("repro_optimizer_update", 100, 400),
    event("aten::mul", 150, 50),
    event("cudaLaunchKernel", 160, 10, corr=7),
    event("aten::add", 600, 50),
    event("cudaLaunchKernel", 610, 10, corr=8),
    event("spin_kernel", 10, 20, linked=99, device=True),
    event("repro_optimizer_update", 290, 80, linked=5, device=True),
    event("k_mul", 300, 50, linked=7, device=True),
    event("k_add", 400, 100, linked=8, device=True),
    event("k_copy", 450, 100, linked=8, device=True),
]


def test_read_synthetic_trace():
  kernels, ranges, busy, gaps = P.read(profile_of(EVENTS))
  assert kernels == {"k_mul": [50e-9, 1], "k_add": [100e-9, 1],
                     "k_copy": [100e-9, 1]}
  assert busy == pytest.approx(200e-9)            # 300-350, 400-550
  assert gaps == {"aten::add": pytest.approx(50e-9)}
  trace = P.Trace(1e-6, busy, kernels, ranges, gaps, 2, "")
  assert trace.range_seconds("repro_optimizer_") == pytest.approx(50e-9)
  assert trace.kernel_seconds("k_") == (pytest.approx(250e-9), 3)
  b = trace.breakdown()
  assert b["device_ops"][0][0] in ("k_add", "k_copy")
  assert b["idle_gaps"] == [["aten::add", pytest.approx(50e-9)]]


def test_unrecorded_counts_launches():
  kernels = {"void flash_kernel<192>": [1.0, 3], "tile_kernel<L2Algebra>":
             [1.0, 4]}
  assert P.unrecorded(kernels, {"flash_attention": 3, "pav_l2": 4,
                                "pav_kl": 0}) == ""
  assert P.unrecorded(kernels, {"flash_attention": 4}) == \
      "flash_attention 3 of 4"


def trace(**kw):
  base = dict(window_s=2.0, busy_s=1.5, kernels={"flash_kernel": [0.5, 4]},
              ranges={"repro_optimizer_update": {(0, "a"): [0.2, 1]},
                      "repro_projection_l2_fused": {(1, "b"): [0.1, 1]},
                      "repro_isotonic_l2_cuda": {(1, "b"): [0.1, 1]}},
              gaps={}, units=2, short="")
  base.update(kw)
  return P.Trace(**base)


def test_readers_on_a_synthetic_trace():
  facts = {"kind": "train", "step_flops": 989e12, "window_steps": 3,
           "window_s": 30.0, "flash_launch_s": [0.05, 0.05]}
  t = trace()
  assert readers.idle_pct(facts, t, "train") == pytest.approx(25.0)
  assert readers.busy_ms(facts, t, "train") == pytest.approx(
      1e3 * t.busy_s / t.units)
  assert readers.range_ms(facts, t, "train", "repro_optimizer_update") == \
      pytest.approx(100.0)
  # nested ranges: the kernel counts once
  assert readers.range_ms(facts, t, "train", "repro_projection_",
                          "repro_isotonic_") == pytest.approx(50.0)
  assert readers.flash_roofline_pct(facts, t, "train") == pytest.approx(40)
  assert readers.peak_share_pct(facts, "train") == pytest.approx(10.0)
  assert readers.idle_pct(facts, t, "decode") is None
  short = trace(short="flash_attention 3 of 4")
  assert readers.flash_roofline_pct(facts, short, "train") is None
  assert readers.idle_pct(facts, short, "train") is None
  missing = trace(kernels={"flash_kernel": [0.5, 3]})
  assert readers.flash_roofline_pct(facts, missing, "train") is None


def test_metric_lines_by_trace():
  env = R.Env.load("dsv2l4.train-lts", 1, "cpu")
  facts = {"kind": "train", "step_flops": 5e13, "window_steps": 20,
           "window_s": 30.0, "flash_launch_s": [1e-4] * 64}
  out = {"metrics": {"train_tokens_per_s": 1e4}}
  e2e = R.cell_metrics(env, out, 40.0, None, facts)
  assert set(e2e) == {"train_tokens_per_s", "setup_s"}
  layer = R.cell_metrics(env, out, 40.0, trace(), facts)
  assert set(layer) == {"train_mfu", "device_idle.train", "busy_ms.train",
                        "optimizer_ms.train", "soft_ops_ms.train"}
  assert all(m["unit"] in ("%", "ms") for m in layer.values())


def test_yardstick_counts():
  env = R.Env.load("dsv2l4.train-lts", 1, "cpu")
  m = env.model
  per_layer = (2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
               + 2048 * 64 + 8 * 3 * 2048 * 1408)
  assert Y.layer_matmul_params(m) == per_layer
  flops = Y.train_step_flops(m, 8, 2048)
  assert 5.3e13 < flops < 5.7e13
  g = R.Env.load("grok1l6.decode-32x2k", 1, "cpu").model
  # the port's own count at 6 layers (its meta-device init)
  assert W.param_count(g) == 31_130_499_072
  assert Y.layer_matmul_params(g) * 6 + Y.head_params(g) == pytest.approx(
      8.58e9, rel=0.01)
  step = Y.decode_step_bytes(g, 32, 2048)
  assert 61e9 < step < 64e9
  # the kernel table's bound: 0.03506 ms at the grok prefill (8 x 512)
  assert Y.flash_least_s(8, 512, 48, 8, 128, 128) * 1e3 == pytest.approx(
      0.03506, rel=0.01)


@pytest.mark.requires_cuda
def test_traced_segment_on_the_card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  x = torch.randn((1024, 1024), device="cuda")

  def run():
    for _ in range(8):
      torch.mm(x, x)
  got = P.traced(run, 8)
  assert got.busy_s > 0 and got.window_s >= got.busy_s and not got.short
  assert sum(n for _, n in got.kernels.values()) >= 8
