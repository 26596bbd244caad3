"""``repro_torch.serving``: shape-bucketed dynamic batching for the soft-op
family.

Counterpart of ``repro.serving``.  Turns a stream of single requests
(arbitrary ``n``, per-request ``eps``, direction and parameters) into
batched launches of the PAV kernels:

* :mod:`repro_torch.serving.bucketing`: shape-bucket policy (pow2 ladder,
  refined with the governing plan's breakpoints);
* :mod:`repro_torch.serving.ops`: the padded batched op family, padded
  exactly (the sliced-back result equals the unpadded operator bit for
  bit, per backend);
* :mod:`repro_torch.serving.aot_cache`: bounded LRU of warmed cells keyed
  by ``(op key, backend, rows, bucket_n, dtype)``;
* :mod:`repro_torch.serving.admission`: bounded admission queue with typed
  load-shedding (reject-on-full, expire-in-queue), never exceptions;
* :mod:`repro_torch.serving.engine`: the micro-batching engine under a
  max-wait / max-batch policy, with ``repro_torch.obs`` counters
  (``serving_admit`` / ``serving_shed`` / ``serving_error`` /
  ``aot_cache_{hit,miss,warm,evict}``) and histograms (queue depth, batch
  occupancy, padding waste, latency).
"""

from repro_torch.serving.admission import (
    AdmissionQueue,
    Request,
    ServeResult,
    STATUS_ERROR,
    STATUS_OK,
    STATUS_SHED_DEADLINE,
    STATUS_SHED_QUEUE_FULL,
)
from repro_torch.serving.aot_cache import AOTExecutableCache
from repro_torch.serving.bucketing import BucketPolicy
from repro_torch.serving.engine import (
    EngineConfig,
    ServingEngine,
    synthetic_stream,
)
from repro_torch.serving.ops import SERVING_OPS, padded_op

__all__ = [
    "AOTExecutableCache",
    "AdmissionQueue",
    "BucketPolicy",
    "EngineConfig",
    "Request",
    "ServeResult",
    "ServingEngine",
    "SERVING_OPS",
    "STATUS_ERROR",
    "STATUS_OK",
    "STATUS_SHED_DEADLINE",
    "STATUS_SHED_QUEUE_FULL",
    "padded_op",
    "synthetic_stream",
]
