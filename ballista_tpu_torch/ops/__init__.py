"""Device operations: aggregation, the one-hot group-sum kernel, concat and
sort."""
