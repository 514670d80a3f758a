"""The benchmark of ``chamjax_torch``, the PyTorch and CUDA port, on one
NVIDIA H100.

``BENCHMARK.json`` at the checkout's root names the cells; each cell's
configuration, traffic mix, limits and per-layer metrics sit in files of
their own here (``spec.py`` finds them by name).  ``run.py`` runs one cell
once; ``calibrate.py`` reads the numbers that decide ``correct`` over
many seeds, for the program, for its lower-precision control and for
the program with its index build broken;
``reference/`` holds the plain references.  Nothing here imports JAX or
the JAX package.
"""
