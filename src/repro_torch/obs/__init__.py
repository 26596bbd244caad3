"""Observability for the port: metrics, tracing, timing, artifacts.

Counterpart of ``repro.obs``.

``repro_torch.obs.metrics``
    The process-local counters and histograms (dispatch resolutions, plan
    decisions, the serving engine's counters, the trainer's step times),
    gated by ``REPRO_TORCH_METRICS``.
``repro_torch.obs.tracing``
    ``torch.profiler`` ranges named like the reference's scopes, so a
    trace attributes kernel time to ``repro_<op>_<reg>_<backend>``.
``repro_torch.obs.timing``
    Wall times with the device synchronised around the call; nearest-rank
    percentiles.
``repro_torch.obs.artifacts``
    The schema-v1 ``BENCH_*.json`` emitter and validator
    (``python -m repro_torch.obs FILE...``).
"""

from repro_torch.obs import artifacts, metrics, timing, tracing
from repro_torch.obs.artifacts import (
    SCHEMA_VERSION,
    bench_payload,
    collect_meta,
    validate_bench_payload,
    write_bench_artifact,
)
from repro_torch.obs.metrics import (
    counter_inc,
    counters,
    enabled,
    histograms,
    observe,
    reset,
    set_enabled,
    snapshot,
)
from repro_torch.obs.timing import time_fn, timed
from repro_torch.obs.tracing import backend_scope, scope_name, trace_annotation

__all__ = [
    "SCHEMA_VERSION",
    "artifacts",
    "backend_scope",
    "bench_payload",
    "collect_meta",
    "counter_inc",
    "counters",
    "enabled",
    "histograms",
    "metrics",
    "observe",
    "reset",
    "scope_name",
    "set_enabled",
    "snapshot",
    "time_fn",
    "timed",
    "timing",
    "trace_annotation",
    "tracing",
    "validate_bench_payload",
    "write_bench_artifact",
]
