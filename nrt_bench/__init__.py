"""The benchmark of the PyTorch and CUDA port (``neural_raytracing_tpu_torch``)
on one NVIDIA H100: the harness, its traffic generator, drivers, per-layer
metric readers and the plain reference that decides ``correct``.  See
``nrt_bench/README.md``."""
