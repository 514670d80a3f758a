"""Document loaders: text files, directories, URLs, and PDFs.

Parity with the reference's URL/PDF embedding demo
(``reranker_hf/yt_embeddings_langchain.py``: a text document fetched from a
URL via ``TextLoader``, a folder of PDFs via ``UnstructuredPDFLoader``, both
chunked and embedded into a FAISS store).  Documents are plain dicts
(``{"text": ..., "source": ...}``) — the shape the splitter and
``VectorStore.from_documents`` already consume — so loaders compose with the
rest of ``chamjax_torch.rag`` without a framework dependency.

The port's own copy of ``chamjax/rag/loaders.py``, which imports no
framework: the same code, so results equal the JAX package's to the last bit.
"""

from __future__ import annotations

import glob as _glob
import os
import re
import zlib
from typing import Dict, List

Document = Dict[str, str]


class TextLoader:
    """One UTF-8 text file → one document."""

    def __init__(self, path: str, encoding: str = "utf-8"):
        self.path = path
        self.encoding = encoding

    def load(self) -> List[Document]:
        with open(self.path, "r", encoding=self.encoding,
                  errors="replace") as f:
            return [{"text": f.read(), "source": self.path}]


class URLLoader:
    """Fetch a document over a URL (the reference demo downloads
    ``state_of_the_union.txt`` over HTTP).  ``file://`` URLs work in
    hermetic environments; network schemes raise the underlying
    ``URLError`` when there is no egress."""

    def __init__(self, url: str, timeout: float = 30.0):
        self.url = url
        self.timeout = timeout

    def load(self) -> List[Document]:
        import urllib.request
        with urllib.request.urlopen(self.url, timeout=self.timeout) as r:
            data = r.read()
        return [{"text": data.decode("utf-8", errors="replace"),
                 "source": self.url}]


class PDFLoader:
    """Minimal PDF text extractor — one PDF → one document.

    Covers the mainstream encoding path (FlateDecode / raw content streams,
    ``Tj`` / ``TJ`` / ``'`` text-showing operators with literal strings);
    enough for machine-generated text PDFs like the reports the reference
    demo indexes.  Pages whose fonts use exotic encodings degrade to the
    characters the literal strings carry."""

    _STREAM = re.compile(rb"stream\r?\n(.*?)endstream", re.DOTALL)
    # literal string followed by a text-showing operator
    _SHOW = re.compile(rb"\(((?:\\.|[^\\()])*)\)\s*(?:Tj|')")
    _SHOW_ARRAY = re.compile(rb"\[((?:\\.|[^\]])*)\]\s*TJ", re.DOTALL)
    _LITERAL = re.compile(rb"\(((?:\\.|[^\\()])*)\)")
    _ESCAPES = {b"n": b"\n", b"r": b"\r", b"t": b"\t", b"b": b"\b",
                b"f": b"\f", b"(": b"(", b")": b")", b"\\": b"\\"}

    def __init__(self, path: str):
        self.path = path

    @classmethod
    def _unescape(cls, raw: bytes) -> bytes:
        out = bytearray()
        i = 0
        while i < len(raw):
            c = raw[i:i + 1]
            if c == b"\\" and i + 1 < len(raw):
                nxt = raw[i + 1:i + 2]
                if nxt.isdigit():                      # octal \ddd
                    j = i + 1
                    while j < min(i + 4, len(raw)) and raw[j:j + 1].isdigit():
                        j += 1
                    out.append(int(raw[i + 1:j], 8) & 0xFF)
                    i = j
                    continue
                out += cls._ESCAPES.get(nxt, nxt)
                i += 2
                continue
            out += c
            i += 1
        return bytes(out)

    def _extract_stream_text(self, content: bytes) -> List[str]:
        parts: List[str] = []
        for m in self._SHOW.finditer(content):
            parts.append(self._unescape(m.group(1)).decode(
                "latin-1", errors="replace"))
        for m in self._SHOW_ARRAY.finditer(content):
            run = b"".join(self._unescape(s.group(1))
                           for s in self._LITERAL.finditer(m.group(1)))
            parts.append(run.decode("latin-1", errors="replace"))
        return parts

    def load(self) -> List[Document]:
        with open(self.path, "rb") as f:
            pdf = f.read()
        if not pdf.startswith(b"%PDF"):
            raise ValueError(f"{self.path}: not a PDF (missing %PDF header)")
        parts: List[str] = []
        for m in self._STREAM.finditer(pdf):
            body = m.group(1)
            try:
                body = zlib.decompress(body)
            except zlib.error:
                pass                 # raw (uncompressed) content stream
            parts.extend(self._extract_stream_text(body))
        return [{"text": "\n".join(p for p in parts if p.strip()),
                 "source": self.path}]


class DirectoryLoader:
    """Load every file matching ``pattern`` under ``path`` (the reference
    demo's PDF-folder ingestion), dispatching on extension: ``.pdf`` →
    :class:`PDFLoader`, anything else → :class:`TextLoader`."""

    def __init__(self, path: str, pattern: str = "*"):
        self.path = path
        self.pattern = pattern

    def load(self) -> List[Document]:
        docs: List[Document] = []
        for p in sorted(_glob.glob(os.path.join(self.path, self.pattern))):
            if not os.path.isfile(p):
                continue
            loader = PDFLoader(p) if p.lower().endswith(".pdf") \
                else TextLoader(p)
            docs.extend(loader.load())
        if not docs:
            raise FileNotFoundError(
                f"no files matched {self.pattern!r} under {self.path}")
        return docs
