"""Twins of the JAX package's workload scripts (``scripts/*.py``), run as
``python -m neural_raytracing_tpu_torch.workloads.<name>``."""
