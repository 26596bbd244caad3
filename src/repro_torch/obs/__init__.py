"""Observability for the port's dispatch layer.

``repro_torch.obs.tracing``
    ``torch.profiler`` ranges named like the reference's scopes, so a
    trace attributes kernel time to ``repro_<op>_<reg>_<backend>``.
"""
