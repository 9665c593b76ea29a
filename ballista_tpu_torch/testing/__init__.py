"""Test support copied from ``ballista_tpu/testing``: the deterministic
fault-injection harness (``faults``, ``BALLISTA_FAULTS``)."""
