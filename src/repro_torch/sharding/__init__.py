"""Sharding rules on a ``DeviceMesh`` (``specs``) and plain-tensor
functions on DTensor blocks (``local``)."""
