"""Columnar batches over torch tensors, Arrow interop, and the bridge from
the reference's batch layout."""
