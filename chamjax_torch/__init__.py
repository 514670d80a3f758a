"""chamjax_torch — chamjax's IVF-PQ query path and RALM serving loop in
PyTorch and CUDA.

A port of the JAX package ``chamjax`` to PyTorch on an NVIDIA Hopper card.
Module names mirror ``chamjax/`` so each counterpart is easy to find:

- ``chamjax_torch.random``  — ``jax.random`` as the JAX package draws from
  it (threefry2x32; on the card the kernel ``csrc/threefry.cu``): every
  seeded corpus, k-means seeding and initial model is the JAX package's.
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
- ``chamjax_torch.models``  — the decoder and encoder-decoder transformer
  (``init_decoder``, ``init_encoder_decoder``, ``decoder_prefill``,
  ``decoder_step``, ``encoder_forward``), the llama family
  (``init_llama``, ``llama_prefill``, ``llama_step``) and the
  ``deepseek_v3`` family (``models.mla_moe``: latent attention over a
  compressed cache, routed experts) and the ``kimi_linear`` family
  (``models.kimi_linear``: KDA layers with a recurrent state beside latent
  attention, a held share of the routed experts, a cache rewound by a
  snapshot), with in-place caches; a decode step's attention is the kernel
  ``csrc/decode_attend.cu`` (``latent_attend.cu`` for ``deepseek_v3`` and
  ``kimi_linear``, whose KDA layers take ``kda_decode.cu``), the encoder's
  ``csrc/encode_attend.cu``;
  ``models.convert`` carries the JAX package's parameters across.
- ``chamjax_torch.retrieval`` — the retriever contract and the in-process
  retrievers ``LocalRetriever`` (over a ``PackedIVF``) and
  ``DeviceRetriever`` (over a ``DeviceIVF``), whose ``retrieve_device``
  takes and returns tensors on the card.
- ``chamjax_torch.serving`` — ``RalmDecoder`` and ``RalmEncoderDecoder``:
  decode steps fused with the on-card retrieval, each family's functions
  chosen once by ``serving.ralm.family``; tik-tok and ``StepProfiler``.
- ``chamjax_torch.ir``      — the BEIR-style IR harness: metrics, the
  loader and synth corpus, lexical, sparse, exact and ANN search, the
  trainable ``DualEncoder`` / ``SparseEncoder`` and the rerankers.
- ``chamjax_torch.rag``     — splitters, loaders, ``VectorStore`` and the
  ``AdvancedRAG`` pipeline with its ``DecoderReader``.

The package imports ``torch`` and ``numpy`` only; it never imports ``jax``
or ``chamjax``.  Entry points (``IVFSearcher``, ``HostStreamedSearcher``,
``build_ivfpq``, ``compute_ground_truth``, ``DeviceIVF.from_packed``, the
model inits and converters, the retrievers, and through their parameters
the RALM loops) run on the card unless the caller passes ``device="cpu"``;
with no card and no explicit CPU device they raise.
"""

__version__ = "0.1.0"
