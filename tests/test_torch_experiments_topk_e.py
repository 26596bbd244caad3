"""Top-k classification (paper Figure 4): the entropic soft top-k loss's
full 150-step training at 100 classes, the port against the reference's
``benchmarks/bench_topk.py``, under the rules of
``test_torch_experiments_topk.py`` (accuracy within one test sample,
1/800).  A file of its own: about a minute on the CPU (the isotonic solve
on (3200, 100) scores a step, in both packages).
"""

from __future__ import annotations

import pytest

pytest.importorskip("torch")

from test_torch_common import (  # noqa: E402,F401
    composed_ref, full_length_accuracy, one_thread, port_scan,
    reference_bench)


def test_topk_full_length_accuracy_of_soft_topk_e_at_100_classes(
    reference_bench, port_scan):
  full_length_accuracy(reference_bench("bench_topk"), "soft_topk_e", 100)
