"""The benchmark harness of the PyTorch and CUDA port (``repro_torch``).

Everything that belongs to one configuration, one traffic mix, one cell
or one metric is a file of its own under ``perfbench/``, found by name:

    perfbench/configs/<config>.json     sizes, the cut, dtype
    perfbench/traffic/<traffic>.json    loop kind, rate or clients, lengths
    perfbench/traffic/<loop>.py         the loop kinds (open_poisson, closed)
    perfbench/cells/<workload>.json     config + traffic + engine + check
    perfbench/metrics/<metric>.py       one reader per metric
    perfbench/reference/<family>.py     the plain float32 references

This package holds what is shared: loading those files, the seeded
weights and inputs, the serving driver, the work arithmetic and the
H100's peaks, the reduction of a profiler trace, and the comparison that
decides ``correct``. It imports nothing of ``jax`` or of the JAX package.
"""
