"""Communication layer: the collective registry and the gradient buckets."""
