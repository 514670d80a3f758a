"""End-to-end RAG pipelines — the reranker_hf-equivalent subsystem (the
port of ``chamjax/rag``).

Rebuild of the reference's advanced-RAG demo & profiling layer
(``reranker_hf/advanced_rag.py:1-295`` — SURVEY.md §2.7): document
splitting, an embedding vector store (exact or IVF-PQ on the card),
retrieve → late-interaction rerank → prompt build → generate, with
per-stage wall-clock timers, ``utils/tracing.py`` spans and NVTX ranges on
the card (the reference's ``torch.cuda.nvtx`` ranges).  The
JAX package's ``JaxDecoderReader`` is :class:`~chamjax_torch.rag.pipeline.
DecoderReader` here.
"""

from chamjax_torch.rag.splitter import (                          # noqa: F401
    CharacterTextSplitter, RecursiveTextSplitter,
)
from chamjax_torch.rag.vector_store import VectorStore            # noqa: F401
from chamjax_torch.rag.pipeline import (                          # noqa: F401
    AdvancedRAG, DecoderReader, EchoReader, StageTimer,
)
from chamjax_torch.rag.loaders import (                           # noqa: F401
    DirectoryLoader, PDFLoader, TextLoader, URLLoader,
)
