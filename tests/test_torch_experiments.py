"""The paper's quality experiments in the port against the reference's
scripts: soft least trimmed squares' data and Figure 6, the three
programs' rows, and ``chip_smoke.py``'s profiler reading.

``repro_torch.experiments`` against ``benchmarks/bench_*.py`` loaded
unchanged (``reference_bench``: the composed projection, fault R1, and
the reference's ``lax`` solver), on the CPU, the port's solves on the
divide and conquer (``port_scan``: the kernels' plain version; the stack
machine, the CPU's default, takes five times as long on these rows).
Each experiment's training runs are held in files of their own
(``test_torch_experiments_{lts,lts_full,ranking,topk,topk_q,topk_e,
allpairs}.py``: each about a minute or less beside the other test files),
under rules that ``chip_smoke.py`` also holds the card to against the CPU.
Here:

* the soft-LTS datasets: bit for bit, the one ``default_rng(0)`` run on
  across Fig. 6's dataset and the five outlier fractions;
* Fig. 6's objectives and ``frac_to_LS``: within 1e-5 * (1 + |ref|), and
  the hard-LTS endpoint that both packages compute as 0.0 (fault R8);
* each ``main(["--device", "cpu"])`` printing the reference's row names
  and derived keys (at 2 steps), ``python -m repro_torch.experiments``
  running the three in the reference's order, each refusing to run
  without a card, and its launches as ``chip_smoke.py`` counts them;
* ``chip_smoke.py::device_reading`` and ``unrecorded`` on fake profiler
  rows: a complete profile, a short one and a reading under the bound;
  the bands (``repro_torch.experiments.BANDS``) that the tests and
  ``chip_smoke.py`` share; and, on the card, a PAV call's kernels.
"""

from __future__ import annotations

import importlib
import importlib.util
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_common import (  # noqa: E402,F401
    ROOT, composed_ref, cuda_device, lts_datasets, one_thread, port_scan,
    reference_bench)

from repro_torch.experiments import __main__ as experiments_main  # noqa: E402
from repro_torch.experiments import band, weights_apart  # noqa: E402
from repro_torch.experiments import bench_label_ranking  # noqa: E402
from repro_torch.experiments import bench_lts  # noqa: E402
from repro_torch.experiments import bench_topk  # noqa: E402

MODULES = {"bench_lts": bench_lts, "bench_label_ranking": bench_label_ranking,
           "bench_topk": bench_topk}


def test_lts_datasets_are_the_references(reference_bench):
  ref = reference_bench("bench_lts")
  for want, got in lts_datasets(ref):
    for w, g in zip(want[:4], got[:4]):
      assert g.dtype == torch.float32
      np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[4], want[4])


def test_fig6_matches_the_reference(reference_bench, port_scan):
  """The five objectives and ``frac_to_LS`` of Fig. 6 (at w = 0)."""
  ref = reference_bench("bench_lts")
  (jx, jy, *_), (x, y, *_) = lts_datasets(ref)[0]
  res = 0.5 * (jy - jx @ jnp.zeros(ref.D)) ** 2
  k = int(0.3 * ref.N)
  hard = float(ref.soft_lts_loss(res, k, 1e-7))
  ls = float(jnp.mean(res))
  got = bench_lts.fig6(x, y)
  assert [eps for eps, _, _ in got] == [1e-4, 1e-2, 1.0, 1e2, 1e5]
  for eps, v, frac in got:
    want_v = float(jnp.mean(ref.soft_lts_loss(res, k, eps)))
    want_frac = (want_v - hard) / max(ls - hard, 1e-9)
    assert abs(v - want_v) <= band("objective", want_v), (eps, v, want_v)
    assert abs(frac - want_frac) <= band("frac_to_LS", want_frac), eps


def test_fault_r8_the_hard_lts_endpoint_is_zero_in_f32(reference_bench,
                                                        port_scan):
  """Fig. 6's hard-LTS endpoint, soft LTS at eps 1e-7, is 0.0 in f32 in
  both packages: the soft sort returns rho / eps - v with rho / eps up to
  5.1e9, whose ulp (512) swallows every residual.  In f64 it is the exact
  hard LTS objective, which the script's ``frac_to_LS`` would measure
  against (the reference's fault R8, reproduced, not repaired)."""
  ref = reference_bench("bench_lts")
  (jx, jy, *_), (x, y, *_) = lts_datasets(ref)[0]
  k = int(0.3 * ref.N)
  res = 0.5 * y ** 2
  assert float(ref.soft_lts_loss(0.5 * jy ** 2, k, 1e-7)) == 0.0
  assert float(bench_lts.soft_lts_loss(res, k, 1e-7)) == 0.0
  exact = torch.sort(res.double(), descending=True).values[k:].mean()
  f64 = bench_lts.soft_lts_loss(res.double(), k, 1e-7)
  assert abs(float(f64) - float(exact)) <= 1e-8 * float(exact)


def _printed_rows(text: str) -> list[tuple[str, list[str]]]:
  """(name, derived keys) of each CSV row printed."""
  rows = []
  for line in text.splitlines():
    parts = line.split(",")
    if len(parts) >= 3 and "/" in parts[0]:
      rows.append((parts[0], [f.split("=")[0] for f in parts[2:]]))
  return rows


@pytest.mark.parametrize("name", sorted(MODULES))
def test_main_prints_the_references_rows(reference_bench, one_thread,
                                         monkeypatch, capsys, name):
  """At 2 steps, ``main(["--device", "cpu"])`` prints the reference's row
  names in its order with its derived keys, and returns the rows it
  printed, each with its metrics unrounded."""
  ref = reference_bench(name)
  mod = MODULES[name]
  monkeypatch.setattr(ref, "STEPS", 2)
  monkeypatch.setattr(mod, "STEPS", 2)
  ref.run()
  want = _printed_rows(capsys.readouterr().out)
  rows = mod.main(["--device", "cpu"])
  got = _printed_rows(capsys.readouterr().out)
  assert got == want and len(got) == len(rows)
  for row, (printed, keys) in zip(rows, got):
    assert row["name"] == printed
    for key in keys:
      assert np.isfinite(row[key])
    assert np.isfinite(row["us_per_call"])


def test_experiments_main_runs_the_three_in_the_references_order(
    one_thread, monkeypatch, capsys):
  """``python -m repro_torch.experiments``: the CSV header, then top-k,
  label ranking and soft LTS (``benchmarks/run.py``'s order)."""
  for mod in MODULES.values():
    monkeypatch.setattr(mod, "STEPS", 1)
  rows = experiments_main.main(["--device", "cpu"])
  out = capsys.readouterr().out.splitlines()
  assert out[0] == "name,us_per_call,derived"
  prefixes = [r["name"].split("/")[0] for r in rows]
  assert prefixes == (["fig4_topk"] * 8 + ["table1_label_ranking"] * 8
                      + ["fig6_interpolation"] * 5
                      + ["fig7_robust_regression"] * 20)
  assert [line.split(",")[0] for line in out[1:]] == [r["name"] for r in rows]


@pytest.mark.parametrize("mod", [*MODULES.values(), experiments_main],
                         ids=[*MODULES, "__main__"])
def test_main_raises_without_a_card(monkeypatch, mod):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    mod.main([])


def _chip_smoke():
  spec = importlib.util.spec_from_file_location("chip_smoke_experiments",
                                                ROOT / "chip_smoke.py")
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


@pytest.mark.parametrize("name", sorted(MODULES))
def test_chip_smoke_counts_each_experiments_launches(one_thread, monkeypatch,
                                                     capsys, name):
  """``chip_smoke.experiment_launches`` from a run's rows equals the
  isotonic solves the run makes (counted at the dispatch layer, at 2
  steps on the CPU)."""
  from repro_torch.kernels import dispatch
  cs = _chip_smoke()
  counts = {"pav_l2": 0, "pav_kl": 0}
  for reg in ("l2", "kl"):
    key = ("isotonic", reg, "stack")
    fn = dispatch._REGISTRY[key]

    def counted(*args, _fn=fn, _k=f"pav_{reg}"):
      counts[_k] += 1
      return _fn(*args)

    monkeypatch.setitem(dispatch._REGISTRY, key, counted)
  mod = MODULES[name]
  monkeypatch.setattr(mod, "STEPS", 2)
  rows = mod.main(["--device", "cpu"])
  capsys.readouterr()
  want = cs.experiment_launches(name, rows)
  assert {k: want[k] for k in counts} == counts
  assert sum(want.values()) == sum(counts.values()) > 0


def _entry(key, count, us, device="CUDA"):
  from torch.autograd import DeviceType
  return types.SimpleNamespace(key=key, count=count,
                               self_device_time_total=us,
                               device_type=getattr(DeviceType, device))


def test_device_reading_of_a_complete_profile():
  """Every launch recorded: device ms a call, summed over the matching
  kernels (``""`` matches every one); CPU entries and the session's pad
  kernels never count."""
  cs = _chip_smoke()
  entries = [_entry("void flash_kernel<64>", 20, 3000.0),
             _entry("aten::copy_", 20, 999.0, "CPU"),
             _entry("Memset (Device)", 20, 40.0),
             _entry("spin_kernel(long)", 16, 8.0)]
  assert cs.device_reading(entries, ("flash_kernel",), 20, 1) == (0.15, "")
  ms, why = cs.device_reading(entries, ("",), 20, 2, bound_ms=0.1)
  assert ms == pytest.approx(0.152) and why == ""
  pav = [_entry("tile_kernel<L2Algebra>", 5, 50.0),
         _entry("merge_kernel<L2Algebra>", 15, 30.0),
         _entry("expand_kernel<KlAlgebra>", 5, 10.0)]
  assert cs.device_reading(pav, ("L2Algebra",), 5, 4)[0] == pytest.approx(
      0.016)


def test_device_reading_refuses_a_short_profile():
  """A session that lost launches gives no reading, never a partial sum."""
  cs = _chip_smoke()
  entries = [_entry("void flash_kernel<64>", 7, 1050.0)]
  ms, why = cs.device_reading(entries, ("flash_kernel",), 20, 1)
  assert ms is None and re.search(r"7 of 20 launches", why)
  ms, why = cs.device_reading([], ("flash_kernel",), 20, 1)
  assert ms is None and "0 of 20" in why
  more = [_entry("void flash_kernel<64>", 21, 3150.0)]
  assert cs.device_reading(more, ("flash_kernel",), 20, 1)[0] is None


def test_device_reading_refuses_a_reading_under_the_bound():
  """Every launch recorded, but less time than the card can take for the
  work: not measured (the training-shape reading of 0.0151 ms against
  the 0.04478 ms bound)."""
  cs = _chip_smoke()
  entries = [_entry("void flash_kernel<64>", 20, 302.0)]
  ms, why = cs.device_reading(entries, ("flash_kernel",), 20, 1,
                              bound_ms=0.04478)
  assert ms is None and "below its bound 0.04478" in why
  assert cs.device_reading(entries, ("flash_kernel",), 20, 1,
                           bound_ms=0.015)[0] == pytest.approx(0.0151)


@pytest.mark.requires_cuda
def test_pav_launches_follow_the_kernels_levels(cuda_device):
  """On the card: one PAV call's CUDA kernels as ``csrc/pav_scan.cu``
  counts them (``pav.kernels_a_call``, what a profiler reading of a PAV
  call is held to): the tile kernel alone up to a tile of 16384, else a
  merge and a move kernel a level above the tile between the tile and
  expand kernels; each slice of 65535 rows launched on its own."""
  from repro_torch.kernels import pav
  assert [pav.kernels_a_call(1, n) for n in (1, 1000, 16384)] == [1] * 3
  assert pav.kernels_a_call(1, 16385) == 4
  assert pav.kernels_a_call(3, 2**20) == 2 + 2 * 6
  assert pav.kernels_a_call(65536, 8) == 2


_PORT_LAUNCHES = {"pav_l2": 4, "pav_kl": 0, "soft_topk_gates": 0,
                  "flash_attention": 16, "flash_attention_simt": 2}


def test_unrecorded_of_a_complete_profile():
  """A profiled call whose records hold every launch the port's wrappers
  counted: each kernel matched by the first kernel of its launch (a PAV
  launch's tile kernel, whatever follows it), any other kernel ignored."""
  cs = _chip_smoke()
  kernels = {
      "void (anonymous namespace)::tile_kernel<(anonymous namespace)::"
      "L2Algebra>(float const*)": [0.2, 4],
      "void (anonymous namespace)::merge_kernel<(anonymous namespace)::"
      "L2Algebra>(float*)": [0.1, 24],
      "void (anonymous namespace)::flash_kernel<64, 64, false>(...)":
          [0.8, 16],
      "void (anonymous namespace)::attention_simt_ffma<8, 1>(...)": [0.3, 2],
      "void at::native::elementwise_kernel<128, 2>(...)": [3.0, 900]}
  assert cs.unrecorded(kernels, _PORT_LAUNCHES) == ""
  assert cs.unrecorded({}, dict.fromkeys(_PORT_LAUNCHES, 0)) == ""


def test_unrecorded_names_each_kernel_short_of_its_launches():
  """A session that lost records, or holds more than were launched, names
  each kernel whose count is not met: ``profile`` then retries, and gives
  no busy time if no try is complete."""
  cs = _chip_smoke()
  kernels = {"void flash_kernel<64, 64, false>(...)": [0.4, 11],
             "void tile_kernel<KlAlgebra>(...)": [0.1, 3],
             "void tile_kernel<L2Algebra>(...)": [0.2, 4],
             "void attention_simt_mma<12, 1>(...)": [0.3, 2]}
  assert cs.unrecorded(kernels, _PORT_LAUNCHES) == (
      "pav_kl 3 of 0, flash_attention 11 of 16")
  assert cs.unrecorded({}, {"soft_topk_gates": 27}) == (
      "soft_topk_gates 0 of 27")


def test_bands_are_one_rule_for_the_tests_and_the_card():
  """``repro_torch.experiments.band`` and ``weights_apart``: Fig. 6's
  metrics relative to 1 + |want|, R^2 and rho absolute, accuracy one test
  sample, the weights relative to 1 + max|want| over every leaf."""
  assert band("objective", 35.0) == pytest.approx(3.6e-4)
  assert band("frac_to_LS", -0.5) == pytest.approx(1.5e-5)
  assert band("r2", 0.99) == band("spearman_rho", -0.9) == 1e-4
  assert band("test_acc", 0.9, 800) == pytest.approx(1 / 800 + 1e-6)
  want = {"w1": np.array([[1.0, -3.0]]), "w2": np.array([0.5])}
  got = {"w1": torch.tensor([[1.0, -3.0002]]), "w2": torch.tensor([0.5])}
  err, tol = weights_apart(got, want)
  assert err == pytest.approx(2e-4, rel=1e-3)
  assert tol == pytest.approx(4e-4)
