"""chamjax_torch — the IVF-PQ query path of chamjax in PyTorch and CUDA.

A port of the JAX package ``chamjax`` to PyTorch on an NVIDIA Hopper card.
Module names mirror ``chamjax/`` so each counterpart is easy to find:

- ``chamjax_torch.data``    — synthetic corpora and exact ground truth.
- ``chamjax_torch.index``   — k-means, PQ/OPQ training and the packed
  IVF-PQ layout (reads and writes the JAX package's npz format).
- ``chamjax_torch.ops``     — coarse scan, LUT construction, window
  expansion, the ADC list scans (hand-written CUDA kernels: the tiled
  layout, ``csrc/adc_scan_tiles.cu``; the flat layout and the padded
  window, ``csrc/adc_scan_flat.cu``) and top-k selection.
- ``chamjax_torch.searcher`` — ``DeviceIVF`` and ``IVFSearcher``.
- ``chamjax_torch.streamed`` — ``HostStreamedSearcher``: codes and ids in
  host memory, each batch's probed windows staged to the card.

The package imports ``torch`` and ``numpy`` only; it never imports ``jax``
or ``chamjax``.  Entry points (``IVFSearcher``, ``HostStreamedSearcher``,
``build_ivfpq``, ``compute_ground_truth``, ``DeviceIVF.from_packed``) run on the card unless
the caller passes ``device="cpu"``; with no card and no explicit CPU device
they raise.
"""

__version__ = "0.1.0"
