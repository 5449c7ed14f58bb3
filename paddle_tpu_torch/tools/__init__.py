"""Tools of the PyTorch port (counterparts of the JAX package's
``tools/loadgen.py``, ``tools/request_trace.py`` and
``tools/perf_report.py``): the open-loop load harness, the
request-timeline renderer and the per-op roofline and step-attribution
report."""
