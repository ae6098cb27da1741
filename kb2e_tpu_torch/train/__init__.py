"""Training: epoch runner, per-batch steps and the epoch loop."""
