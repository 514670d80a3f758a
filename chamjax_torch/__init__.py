"""chamjax_torch — the IVF-PQ query path of chamjax in PyTorch and CUDA.

A port of the JAX package ``chamjax`` to PyTorch on an NVIDIA Hopper card.
Module names mirror ``chamjax/`` so each counterpart is easy to find:

- ``chamjax_torch.data``    — synthetic corpora and exact ground truth.
- ``chamjax_torch.index``   — k-means, PQ/OPQ training and the packed
  IVF-PQ layout (reads and writes the JAX package's npz format).
- ``chamjax_torch.ops``     — coarse scan, LUT construction, window
  expansion, the ADC list scan (a hand-written CUDA kernel for the tiled
  layout, ``csrc/adc_scan_tiles.cu``) and top-k selection.
- ``chamjax_torch.searcher`` — ``DeviceIVF`` and ``IVFSearcher``.

The package imports ``torch`` and ``numpy`` only; it never imports ``jax``
or ``chamjax``.  Entry points (``IVFSearcher``, ``build_ivfpq``,
``compute_ground_truth``, ``DeviceIVF.from_packed``) run on the card unless
the caller passes ``device="cpu"``; with no card and no explicit CPU device
they raise.
"""

__version__ = "0.1.0"
