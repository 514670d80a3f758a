"""Hierarchical document splitter.

Parity with the reference's chunking stage
(``reranker_hf/advanced_rag.py:96-132``: LangChain
``RecursiveCharacterTextSplitter`` with markdown separators, 512-token
chunks, 10% overlap, and duplicate removal): split on the strongest
separator that keeps chunks under the limit, recursing into weaker
separators, then merge small pieces with overlap and dedupe.

The port's own copy of ``chamjax/rag/splitter.py``, which imports no
framework: the same code, so results equal the JAX package's to the last bit.
"""

from __future__ import annotations

from typing import Dict, List, Optional

# literal separators (``_split_on`` is str.split-based — LangChain's regex
# classes like "\n#{1,6} " are expanded to their literal forms, strongest
# first, or they would never match anything)
MARKDOWN_SEPARATORS = ["\n# ", "\n## ", "\n### ", "\n#### ", "\n##### ",
                       "\n###### ", "```\n", "\n***\n", "\n---\n", "\n___\n",
                       "\n\n", "\n", " ", ""]
_PLAIN_SEPARATORS = ["\n\n", "\n", " ", ""]


class RecursiveTextSplitter:
    def __init__(self, chunk_size: int = 512, chunk_overlap: int = 50,
                 separators: Optional[List[str]] = None,
                 length_fn=len):
        self.chunk_size = chunk_size
        self.chunk_overlap = chunk_overlap
        self.separators = separators or _PLAIN_SEPARATORS
        self.length = length_fn

    def _split_on(self, text: str, separators: List[str]) -> List[str]:
        sep, rest = separators[0], separators[1:]
        parts = text.split(sep) if sep else list(text)
        out: List[str] = []
        for i, p in enumerate(parts):
            piece = p + (sep if sep and i < len(parts) - 1 else "")
            if self.length(piece) <= self.chunk_size or not rest:
                out.append(piece)
            else:
                out.extend(self._split_on(piece, rest))
        return out

    def split_text(self, text: str) -> List[str]:
        pieces = self._split_on(text, self.separators)
        # merge consecutive pieces up to chunk_size, with overlap carry
        chunks: List[str] = []
        cur = ""
        for p in pieces:
            if cur and self.length(cur) + self.length(p) > self.chunk_size:
                chunks.append(cur)
                cur = cur[max(0, len(cur) - self.chunk_overlap):]
                if cur and self.length(cur) + self.length(p) > self.chunk_size:
                    # drop the overlap carry rather than emit a chunk over
                    # the limit — downstream encoders size max_tokens to
                    # chunk_size, and an oversized chunk silently truncates
                    cur = ""
            cur += p
        if cur.strip():
            chunks.append(cur)
        return [c for c in chunks if c.strip()]

    def split_documents(self, docs: List[Dict[str, str]]
                        ) -> List[Dict[str, str]]:
        """docs: [{"text": ..., **metadata}] → chunk docs, deduped
        (reference dedupes chunks by content, advanced_rag.py:122-132)."""
        seen = set()
        out: List[Dict[str, str]] = []
        for doc in docs:
            for chunk in self.split_text(doc.get("text", "")):
                key = chunk.strip()
                if key in seen:
                    continue
                seen.add(key)
                out.append({**{k: v for k, v in doc.items() if k != "text"},
                            "text": chunk})
        return out


class CharacterTextSplitter(RecursiveTextSplitter):
    """Single-separator splitter — the flavor the reference's URL/PDF demo
    uses (``yt_embeddings_langchain.py``: LangChain ``CharacterTextSplitter``
    with ``chunk_size=1000, chunk_overlap=0``).  Splits on one separator
    only, then merges pieces up to ``chunk_size``; a lone piece longer than
    ``chunk_size`` is kept whole (same semantics as the original)."""

    def __init__(self, chunk_size: int = 1000, chunk_overlap: int = 0,
                 separator: str = "\n\n", length_fn=len):
        super().__init__(chunk_size=chunk_size, chunk_overlap=chunk_overlap,
                         separators=[separator], length_fn=length_fn)
