"""Fixed-iteration LM solvers: pose-only optimizers and bundle adjustment."""
