"""chamjax_torch.rag on the CPU: one counterpart for each test of
``tests/test_rag.py``, then parity
with the JAX package: the splitters and loaders (framework-free copies)
equal; ``VectorStore`` exact and ivfpq over the same embeddings and the same
index up to the order of score ties (rtol 1e-5); ``AdvancedRAG.answer`` with
``EchoReader`` equal; ``DecoderReader`` tokens equal from carried weights
(float32: a bf16 decoder rounds differently in each package, so its greedy
tokens are not held equal)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from chamjax_torch.ir.dense import HashingEncoder
from chamjax_torch.ir.rerank import MaxSimReranker
from chamjax_torch.rag import AdvancedRAG, RecursiveTextSplitter, VectorStore
from chamjax_torch.rag.pipeline import DecoderReader, EchoReader, StageTimer

from test_rag import _toy_docs, _write_minimal_pdf

CPU = dict(device="cpu")


# --- counterparts of tests/test_rag.py ---------------------------------------


def test_splitter_chunks_and_overlap():
    text = ("para one about cooking.\n\n" + "word " * 100 +
            "\n\npara two about space rockets.\n\n" + "tail " * 50)
    chunks = RecursiveTextSplitter(chunk_size=120,
                                   chunk_overlap=20).split_text(text)
    assert len(chunks) >= 3 and all(len(c) <= 120 for c in chunks)
    joined = "".join(chunks)
    for probe in ("para one", "para two", "tail"):
        assert probe in joined


def test_splitter_dedupes_documents():
    docs = [{"text": "same chunk body", "src": "a"},
            {"text": "same chunk body", "src": "b"},
            {"text": "different body", "src": "c"}]
    out = RecursiveTextSplitter(chunk_size=100).split_documents(docs)
    assert len(out) == 2 and {d["src"] for d in out} == {"a", "c"}


def test_vector_store_exact_and_save_load(tmp_path):
    enc = HashingEncoder(dim=64)
    store = VectorStore.from_documents(_toy_docs(), enc, **CPU)
    hits = store.similarity_search("rocket orbit astronaut", k=5)
    assert len(hits) == 5 and all(d["title"] == "space" for d, _ in hits)
    scores = [s for _, s in hits]
    assert scores == sorted(scores, reverse=True)
    store.save(str(tmp_path / "vs"))
    store2 = VectorStore.load(str(tmp_path / "vs"), enc, **CPU)
    hits2 = store2.similarity_search("rocket orbit astronaut", k=5)
    assert [d["text"] for d, _ in hits] == [d["text"] for d, _ in hits2]


def ivfpq_store(docs, enc, **kw):
    from chamjax_torch.config import IndexConfig
    return VectorStore.from_documents(
        docs, enc, backend="ivfpq",
        index_cfg=IndexConfig(dim=64, nlist=8, m=8, list_pad=64), nprobe=8,
        **kw)


def test_vector_store_ivfpq_backend():
    store = ivfpq_store(_toy_docs(), HashingEncoder(dim=64), **CPU)
    hits = store.similarity_search("flour sugar pastry oven", k=5)
    assert len(hits) == 5
    assert sum(d["title"] == "cooking" for d, _ in hits) >= 4


def test_advanced_rag_end_to_end():
    store = VectorStore.from_documents(_toy_docs(), HashingEncoder(dim=64),
                                       **CPU)
    rag = AdvancedRAG(store, EchoReader(),
                      reranker=MaxSimReranker(dim=32, max_tokens=12, **CPU),
                      n_retrieved=10, n_final=3)
    answer, ctx = rag.answer("how do I bake pastry with flour and butter")
    assert len(ctx) == 3 and all(d["title"] == "cooking" for d in ctx)
    assert answer
    assert {"retrieval", "rerank", "prompt_build",
            "generate"} <= set(rag.timer.stats_ms())


def test_doc_qa_end_to_end(tmp_path):
    """The demo's full flow: load URL → split → embed → retrieve → answer,
    and the same answer and context as chamjax's flow over the same file."""
    from chamjax.rag import AdvancedRAG as JAdvancedRAG
    from chamjax.rag import CharacterTextSplitter as JSplitter
    from chamjax.rag import URLLoader as JURLLoader
    from chamjax.rag import VectorStore as JVectorStore
    from chamjax.rag.pipeline import EchoReader as JEchoReader
    from chamjax.ir.dense import HashingEncoder as JHashingEncoder

    from chamjax_torch.rag import CharacterTextSplitter, URLLoader
    p = tmp_path / "sotu.txt"
    p.write_text("The economy grew strongly this year.\n\n"
                 "The supreme court gained a new justice of great renown.\n\n"
                 "Rural broadband expanded to five million homes.\n")
    docs = URLLoader(p.as_uri()).load()
    chunks = CharacterTextSplitter(chunk_size=80).split_documents(docs)
    assert len(chunks) >= 2
    store = VectorStore.from_documents(chunks, HashingEncoder(dim=128), **CPU)
    rag = AdvancedRAG(store, EchoReader(), n_retrieved=2, n_final=1)
    question = "what about the supreme court justice"
    answer, ctx = rag.answer(question)
    assert "supreme court" in ctx[0]["text"].lower()
    assert answer
    j_chunks = JSplitter(chunk_size=80).split_documents(
        JURLLoader(p.as_uri()).load())
    j_store = JVectorStore.from_documents(j_chunks, JHashingEncoder(dim=128))
    j_answer, j_ctx = JAdvancedRAG(j_store, JEchoReader(), n_retrieved=2,
                                   n_final=1).answer(question)
    assert (answer, ctx) == (j_answer, j_ctx)


def test_decoder_reader_generates():
    r = DecoderReader(max_new_tokens=4, **CPU)
    out = r.generate("what is a rocket?")
    assert len(out.split()) == 4
    assert out == r.generate("what is a rocket?")


def test_text_and_url_loaders(tmp_path):
    from chamjax_torch.rag import TextLoader, URLLoader
    p = tmp_path / "doc.txt"
    p.write_text("the president spoke about the supreme court\n")
    docs = TextLoader(str(p)).load()
    assert docs[0]["text"].startswith("the president")
    assert docs[0]["source"] == str(p)
    docs2 = URLLoader(p.as_uri()).load()
    assert docs2[0]["text"] == docs[0]["text"]
    assert docs2[0]["source"].startswith("file://")


PDF_CONTENT = (b"BT /F1 12 Tf (Hello \\(PDF\\) world) Tj "
               b"[(cham) -250 (jax loaders)] TJ (line\\n2) ' ET")
PDF_OCTAL = b"BT (\\101\\102\\103) Tj ET"


def test_pdf_loader_extracts_text(tmp_path):
    from chamjax_torch.rag import PDFLoader
    pdf = tmp_path / "doc.pdf"
    _write_minimal_pdf(str(pdf), [(PDF_CONTENT, True), (PDF_OCTAL, False)])
    text = PDFLoader(str(pdf)).load()[0]["text"]
    for probe in ("Hello (PDF) world", "chamjax loaders", "line\n2", "ABC"):
        assert probe in text


def test_pdf_loader_rejects_non_pdf(tmp_path):
    from chamjax_torch.rag import PDFLoader
    p = tmp_path / "fake.pdf"
    p.write_bytes(b"not a pdf at all")
    with pytest.raises(ValueError):
        PDFLoader(str(p)).load()


def test_directory_loader_mixed(tmp_path):
    from chamjax_torch.rag import DirectoryLoader
    (tmp_path / "a.txt").write_text("alpha text")
    _write_minimal_pdf(str(tmp_path / "b.pdf"),
                       [(b"BT (beta pdf) Tj ET", True)])
    docs = DirectoryLoader(str(tmp_path)).load()
    assert len(docs) == 2
    texts = " | ".join(d["text"] for d in docs)
    assert "alpha text" in texts and "beta pdf" in texts
    with pytest.raises(FileNotFoundError):
        DirectoryLoader(str(tmp_path), "*.docx").load()


def test_character_splitter_semantics():
    from chamjax_torch.rag import CharacterTextSplitter
    text = "para one.\n\npara two is a bit longer.\n\n" + "x" * 150
    chunks = CharacterTextSplitter(chunk_size=60,
                                   chunk_overlap=0).split_text(text)
    assert any("para one" in c and "para two" in c for c in chunks)
    assert any(len(c) >= 150 for c in chunks)
    assert "".join(chunks).count("x" * 150) == 1


def test_splitter_never_exceeds_chunk_size_with_overlap():
    chunks = RecursiveTextSplitter(chunk_size=100,
                                   chunk_overlap=30).split_text("word " * 500)
    assert len(chunks) > 3 and all(len(c) <= 100 for c in chunks)


def test_markdown_separators_are_literal_and_split_headings():
    from chamjax_torch.rag.splitter import MARKDOWN_SEPARATORS
    text = ("intro\n## section one\n" + "alpha " * 20 +
            "\n## section two\n" + "beta " * 20)
    chunks = RecursiveTextSplitter(chunk_size=80, chunk_overlap=0,
                                   separators=MARKDOWN_SEPARATORS
                                   ).split_text(text)
    one = next(c for c in chunks if "section one" in c)
    two = next(c for c in chunks if "section two" in c)
    assert one is not two
    assert "beta" not in one and "alpha" not in two


# --- parity with the JAX package ---------------------------------------------


def test_splitters_and_loaders_equal_chamjax(tmp_path):
    import chamjax.rag as jrag
    import chamjax_torch.rag as trag
    from chamjax.rag.splitter import MARKDOWN_SEPARATORS
    text = ("# head\n\npara one.\n\n" + "word " * 90 + "\n## two\n"
            + "tail " * 40 + "\n\n" + "x" * 130)
    for kw in (dict(chunk_size=120, chunk_overlap=20),
               dict(chunk_size=80, chunk_overlap=0,
                    separators=MARKDOWN_SEPARATORS)):
        assert trag.RecursiveTextSplitter(**kw).split_text(text) == \
            jrag.RecursiveTextSplitter(**kw).split_text(text)
    assert trag.CharacterTextSplitter(chunk_size=60).split_text(text) == \
        jrag.CharacterTextSplitter(chunk_size=60).split_text(text)
    (tmp_path / "a.txt").write_text("alpha text\nsecond line")
    _write_minimal_pdf(str(tmp_path / "b.pdf"),
                       [(PDF_CONTENT, True), (PDF_OCTAL, False)])
    for name in ("TextLoader", "PDFLoader"):
        path = str(tmp_path / ("a.txt" if name == "TextLoader" else "b.pdf"))
        assert getattr(trag, name)(path).load() == \
            getattr(jrag, name)(path).load()
    uri = (tmp_path / "a.txt").as_uri()
    assert trag.URLLoader(uri).load() == jrag.URLLoader(uri).load()
    assert trag.DirectoryLoader(str(tmp_path)).load() == \
        jrag.DirectoryLoader(str(tmp_path)).load()
    docs = [{"text": text, "src": "a"}, {"text": text, "src": "b"}]
    assert trag.RecursiveTextSplitter(chunk_size=100).split_documents(docs) \
        == jrag.RecursiveTextSplitter(chunk_size=100).split_documents(docs)


def same_hits(got, want, rtol=1e-5):
    """Two hit lists [(doc, score)] of one query: scores within rtol rank
    by rank, docs equal except in the order of ties."""
    from chamjax_torch.eval import tie_mismatches
    key = lambda d: hash(repr(sorted(d.items()))) % (1 << 40)  # noqa: E731
    dg = np.array([[-s for _, s in got]], np.float32)
    dw = np.array([[-s for _, s in want]], np.float32)
    ig = np.array([[key(d) for d, _ in got]])
    iw = np.array([[key(d) for d, _ in want]])
    bad = tie_mismatches(dg, ig, dw, iw, rtol=rtol, atol=rtol)
    assert not bad, bad


QUERIES = ("rocket orbit astronaut", "flour sugar pastry oven",
           "market bond yield", "planet launch recipe")


def test_vector_store_exact_equal_chamjax(tmp_path):
    """The same hits from the same embeddings, and a store saved by the JAX
    package loads in the port."""
    from chamjax.ir.dense import HashingEncoder as JHash
    from chamjax.rag import VectorStore as JStore
    docs = _toy_docs()
    j = JStore.from_documents(docs, JHash(dim=64))
    j.save(str(tmp_path / "vs"))
    t = VectorStore.load(str(tmp_path / "vs"), HashingEncoder(dim=64), **CPU)
    t2 = VectorStore.from_documents(docs, HashingEncoder(dim=64), **CPU)
    np.testing.assert_array_equal(t.emb, t2.emb)
    for q in QUERIES:
        want = j.similarity_search(q, k=8)
        same_hits(t.similarity_search(q, k=8), want)
        same_hits(t2.similarity_search(q, k=8), want)


def test_vector_store_ivfpq_equal_chamjax():
    """Both stores over the JAX package's index (carried across): the same
    hits up to ties.  The JAX searcher scans in interpret mode."""
    from chamjax.config import IndexConfig
    from chamjax.ir.dense import HashingEncoder as JHash
    from chamjax.rag import VectorStore as JStore
    from test_torch_search import carry
    docs = _toy_docs()
    j = JStore.from_documents(
        docs, JHash(dim=64), backend="ivfpq",
        index_cfg=IndexConfig(dim=64, nlist=8, m=8, list_pad=64), nprobe=8)
    want = [j.similarity_search(q, k=8) for q in QUERIES]
    t = VectorStore.from_documents(docs, HashingEncoder(dim=64),
                                   backend="ivfpq", nprobe=8, **CPU)
    t.index = carry(j._searcher.packed)
    for q, w in zip(QUERIES, want):
        same_hits(t.similarity_search(q, k=8), w)


def test_advanced_rag_echo_equal_chamjax():
    from chamjax.ir.dense import HashingEncoder as JHash
    from chamjax.ir.rerank import MaxSimReranker as JMaxSim
    from chamjax.rag import AdvancedRAG as JRAG
    from chamjax.rag import VectorStore as JStore
    from chamjax.rag.pipeline import EchoReader as JEcho
    docs = _toy_docs()
    t = AdvancedRAG(VectorStore.from_documents(docs, HashingEncoder(dim=64),
                                               **CPU), EchoReader(),
                    reranker=MaxSimReranker(dim=32, max_tokens=12, **CPU),
                    n_retrieved=10, n_final=3)
    j = JRAG(JStore.from_documents(docs, JHash(dim=64)), JEcho(),
             reranker=JMaxSim(dim=32, max_tokens=12), n_retrieved=10,
             n_final=3)
    for q in QUERIES:
        assert t.answer(q) == j.answer(q)


def f32_reader_pair():
    from chamjax.config import ModelConfig as JCfg
    from chamjax.rag.pipeline import JaxDecoderReader
    from chamjax_torch.config import ModelConfig
    from chamjax_torch.models.convert import decoder_from_numpy
    jcfg = JCfg(model_type="decoder", embed_dim=64, ffn_embed_dim=128,
                layers=2, attention_heads=4, vocab_size=500, max_seq_len=32,
                dtype="float32")
    j = JaxDecoderReader(cfg=jcfg, max_new_tokens=12, seed=1)
    t = DecoderReader(cfg=ModelConfig(**dataclasses.asdict(jcfg)),
                      max_new_tokens=12, **CPU)
    t.params = decoder_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), j.params), t.cfg,
        **CPU)
    return j, t


def test_decoder_reader_tokens_equal_chamjax():
    j, t = f32_reader_pair()
    for prompt in ("what is a rocket?", "", "Context:\nDocument 0:::\nx"):
        assert t.generate(prompt) == j.generate(prompt)
        assert t.generate(prompt, max_new_tokens=5) == \
            j.generate(prompt, max_new_tokens=5)
    assert t.cache.host_idx == 0                 # emptied at each generate


def test_stage_timer_spans_reach_the_profiler():
    timer = StageTimer()
    with torch.profiler.profile() as prof:
        with timer.span("retrieval"):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "retrieval" in names
    assert timer.stats_ms()["retrieval"]["count"] == 1
