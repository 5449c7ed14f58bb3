"""Serving tools of the PyTorch port (counterparts of the JAX package's
``tools/loadgen.py`` and ``tools/request_trace.py``): the open-loop load
harness and the request-timeline renderer."""
