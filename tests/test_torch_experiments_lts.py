"""Soft least trimmed squares (paper §6.4, Figure 7) in the port against
the reference's ``benchmarks/bench_lts.py``: each loss's training (the
full 300-step runs in ``test_torch_experiments_lts_full.py``).

``repro_torch.experiments.bench_lts.fit`` against the script's ``fit``,
loaded unchanged (``reference_bench``: the composed projection, fault R1,
and the reference's ``lax`` solver), on each of the five outlier
fractions' datasets, on the CPU; the port's solves on the divide and
conquer (``port_scan``).  Rules, which ``chip_smoke.py`` also holds the
card to against the CPU:

* ``w`` after 5 steps of each loss: within 1e-5 * (1 + max|ref|);
* R^2 after the full 300 steps: within ``R2_BAND`` = 1e-4.  Measured
  here: 0 apart (``w`` within 8e-8 of the reference's).  Each loss's
  tight check is its 5-step ``w``: at full length R^2 saturates near 1
  (Huber and the LTS losses end within 3.1e-5 of each other at 10%
  outliers), so the band asks that the two runs end at the same fit,
  with room for the card's f32 sums in another order over 300 steps,
  while what least squares loses to the outliers (2.3e-2 to 0.27 of R^2
  from 10% on) is over 200 times the band;
* ``hard_lts`` (eps 1e-7: its gradient jumps whenever the trimmed set
  changes, so an ulp could send it down another path) has its own rule:
  after the full 300 steps the points it keeps (the N - k smallest
  residuals at the final ``w``) are the reference's, as well as R^2
  within ``R2_BAND``.  Here it took the same path (its ``w`` within 8e-8).
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("torch")

from test_torch_common import (  # noqa: E402,F401
    assert_close, composed_ref, lts_datasets, one_thread, port_scan,
    reference_bench)

from repro_torch.experiments import bench_lts  # noqa: E402


@pytest.mark.parametrize("kind", bench_lts.KINDS)
def test_lts_five_steps_match_the_reference(reference_bench, port_scan,
                                            monkeypatch, kind):
  """``w`` after 5 steps of each loss on each outlier fraction."""
  ref = reference_bench("bench_lts")
  monkeypatch.setattr(ref, "STEPS", 5)
  for want, got in lts_datasets(ref)[1:]:
    want_w = np.asarray(ref.fit(kind, want[0], want[1]))
    w = bench_lts.fit(kind, got[0], got[1], steps=5)
    assert_close(w, want_w, want_w)
