"""Observability for the port.

``repro_torch.obs.tracing``
    ``torch.profiler`` ranges named like the reference's scopes, so a
    trace attributes kernel time to ``repro_<op>_<reg>_<backend>``.
``repro_torch.obs.metrics``
    The process-local counters and histograms (the trainer's step times).
"""
