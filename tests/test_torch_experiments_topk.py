"""Top-k classification (paper Figure 4, left and center) in the port
against the reference's ``benchmarks/bench_topk.py``.

``repro_torch.experiments.bench_topk`` against the script's own functions,
loaded unchanged (``reference_bench``: the composed projection, fault R1,
and the reference's ``lax`` solver), on the CPU; the port's solves on the
divide and conquer (``port_scan``).  The reference draws its initial
weights with ``jax.random.PRNGKey(0)``; they are carried across as numpy
(``mlp_from_numpy``), so both trainings start alike.  Rules, which
``chip_smoke.py`` also holds the card to against the CPU:

* the cluster data at 10 and 100 classes, from one shared
  ``default_rng(0)``: bit for bit;
* both weights after 5 steps of each loss at both class counts: within
  1e-5 * (1 + max|ref|);
* top-1 accuracy after the full 150 steps: within one test sample
  (1 / n_test: 1/80 and 1/800).  Measured here: equal for every loss.

The 150-step runs at 100 classes of the soft top-k losses and of
``allpairs`` (a (3200, 100, 100) tensor a step) take about a minute each
on the CPU beside the other test files, and have files of their own
(``test_torch_experiments_topk_{q,e}.py``,
``test_torch_experiments_allpairs.py``).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_common import (  # noqa: E402,F401
    assert_close, composed_ref, full_length_accuracy, one_thread, port_scan,
    reference_bench, reference_topk_train, topk_datasets)

from repro_torch.experiments import bench_topk  # noqa: E402


def test_topk_datasets_are_the_references(reference_bench):
  ref = reference_bench("bench_topk")
  for _, want, got in topk_datasets(ref):
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int64
    for w, g in zip(want, got):
      np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_mlp_init_draws_the_references_scales():
  """The port's own initial weights: seeded, on the CPU whatever the
  device, at the reference's shapes and scales (1 / sqrt(fan-in))."""
  a, b = bench_topk.mlp_init(100), bench_topk.mlp_init(100)
  for k in ("w1", "w2"):
    assert torch.equal(a[k], b[k]) and a[k].dtype == torch.float32
  assert a["w1"].shape == (32, 64) and a["w2"].shape == (64, 100)
  assert abs(float(a["w1"].std()) * np.sqrt(32) - 1) < 0.05
  assert abs(float(a["w2"].std()) * np.sqrt(64) - 1) < 0.05


@pytest.mark.parametrize("kind", bench_topk.KINDS)
def test_topk_five_steps_match_the_reference(reference_bench, port_scan,
                                             kind):
  """Both weights after 5 steps of ``kind`` at 10 and 100 classes, from
  the reference's ``mlp_init(PRNGKey(0))``."""
  ref = reference_bench("bench_topk")
  for n_classes, (jx, jy), (x, y) in topk_datasets(ref):
    n = int(len(x) * 0.8)
    init, final = reference_topk_train(ref, kind, n_classes, jx[:n], jy[:n],
                                       5)
    params = bench_topk.train(bench_topk.losses()[kind],
                              bench_topk.mlp_from_numpy(**init), x[:n],
                              y[:n], 5)
    for k in ("w1", "w2"):
      assert_close(params[k], final[k], final[k])


@pytest.mark.parametrize("kind", bench_topk.KINDS)
def test_topk_full_length_accuracy_at_10_classes(reference_bench, port_scan,
                                                 kind):
  full_length_accuracy(reference_bench("bench_topk"), kind, 10)


def test_topk_full_length_accuracy_of_cross_entropy_at_100_classes(
    reference_bench, port_scan):
  full_length_accuracy(reference_bench("bench_topk"), "cross_entropy", 100)
