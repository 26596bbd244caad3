"""The port's tools that derive and gate the packaged execution plan.

Counterparts of the reference's ``tools/autotune.py`` and
``tools/check_backends.py``, and of the two speed sweeps that autotune
reads (``benchmarks/bench_runtime.py::run_backend_sweep``,
``benchmarks/bench_projection.py::run``).  Each imports ``torch`` and
nothing of the JAX package, and runs on the card unless ``--device cpu``
is given.

``sweeps``
    ``run_backend_sweep`` and ``run_projection``: soft_rank's forward and
    forward + backward by isotonic backend over an (n, batch) grid, and the
    fused projection against the composed one, written as schema-v1
    artifacts.
``autotune``
    ``python -m repro_torch.tools.autotune [--run | --smoke]``: the
    measured plan (``repro_torch/plan/default_plan.json``) from those
    artifacts, every rule citing the timing rows behind it.
``check_backends``
    ``python -m repro_torch.tools.check_backends``: the README's backend
    table, the artifacts' coverage, fused not slower than composed, and
    every plan rule backed by its evidence.
"""
