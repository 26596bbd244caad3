"""Top-k classification (paper Figure 4): the all-pairs baseline's full
150-step training at 100 classes, the port against the reference's
``benchmarks/bench_topk.py``, under the rules of
``test_torch_experiments_topk.py`` (accuracy within one test sample,
1/800).  A file of its own: a (3200, 100, 100) tensor a step, forward and
backward, in both packages.  The port's side runs on ``THREADS`` threads:
a step is a dozen ops on 128 MB tensors, which the thread pool divides,
where the small ops of the other files' loops only spin (beside the other
five experiment files under ``-n 6 --dist loadfile`` on 8 cores, this
test took 143 s on one thread and 92 s on four).
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from test_torch_common import (  # noqa: E402,F401
    composed_ref, full_length_accuracy, reference_bench)

THREADS = 4


@pytest.fixture
def threads():
  n = torch.get_num_threads()
  torch.set_num_threads(THREADS)
  yield
  torch.set_num_threads(n)


def test_topk_full_length_accuracy_of_allpairs_at_100_classes(
    reference_bench, threads):
  full_length_accuracy(reference_bench("bench_topk"), "allpairs", 100)
