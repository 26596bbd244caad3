"""Soft least trimmed squares (paper §6.4, Figure 7): each loss's full
300-step training in the port against the reference's
``benchmarks/bench_lts.py``, on each outlier fraction's dataset, under
the rules stated in ``test_torch_experiments_lts.py``: ``w`` and R^2
within their ``BANDS``, and for ``hard_lts`` also the points it keeps.  A
file of its own: about a minute on the CPU beside the other test files.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("torch")

from test_torch_common import (  # noqa: E402,F401
    composed_ref, lts_datasets, one_thread, port_scan, reference_bench)

from repro_torch.experiments import band, weights_apart  # noqa: E402
from repro_torch.experiments import bench_lts  # noqa: E402


@pytest.mark.parametrize("kind", bench_lts.KINDS)
def test_lts_full_length_r2_matches_the_reference(reference_bench, port_scan,
                                                  kind):
  """``w`` and R^2 after the full 300 steps within their bands; for
  ``hard_lts`` also the points it keeps."""
  ref = reference_bench("bench_lts")
  k = int(bench_lts.TRIM * bench_lts.N)
  for (jx, jy, jxte, jyte, _), (x, y, xte, yte, _) in lts_datasets(ref)[1:]:
    want_w = ref.fit(kind, jx, jy)
    w = bench_lts.fit(kind, x, y)
    err, tol = weights_apart({"w": w}, {"w": want_w})
    assert err <= tol, (kind, err, tol)
    want = float(ref.r2(want_w, jxte, jyte))
    assert abs(bench_lts.r2(w, xte, yte) - want) <= band("r2", want)
    if kind == "hard_lts":
      want_res = np.asarray((jy - jx @ want_w) ** 2)
      res = ((y - x @ w) ** 2).numpy()
      assert (set(np.argsort(res, kind="stable")[:bench_lts.N - k])
              == set(np.argsort(want_res, kind="stable")[:bench_lts.N - k]))
