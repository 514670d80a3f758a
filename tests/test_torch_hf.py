"""The HuggingFace-model classes of ``chamjax_torch.ir`` (``HFEncoder``,
``HFCrossEncoder``, ``QueryGenerator``) on the CPU, on random checkpoints
that the tests write with ``save_pretrained`` (a BERT vocabulary written
here; no download), each against chamjax's class on the same directory."""

import numpy as np
import pytest
import torch

from chamjax.ir.dense import HFEncoder as JHFEncoder
from chamjax.ir.rerank import HFCrossEncoder as JHFCrossEncoder
from chamjax.ir.train import QueryGenerator as JQueryGenerator

from chamjax_torch.ir.dense import HFEncoder
from chamjax_torch.ir.rerank import HFCrossEncoder, Rerank
from chamjax_torch.ir.train import QueryGenerator

transformers = pytest.importorskip("transformers")

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "the", "cat", "sat", "on", "mat", "dog", "ran", "a", "big", "red"]
TEXTS = ["the cat sat", "dog ran", "the dog sat on the mat",
         "a big red cat ran on the mat"]
PAIRS = [("the cat", "the cat sat on the mat"), ("dog", "a big red dog"),
         ("mat", "the dog ran"), ("red cat", "a big red cat sat")]
CPU = dict(device="cpu")


def tokenizer(tmp_path, **kw):
    vpath = tmp_path / "vocab.txt"
    vpath.write_text("\n".join(VOCAB))
    return transformers.BertTokenizer(str(vpath), do_lower_case=True, **kw)


def bert_config(**kw):
    return transformers.BertConfig(
        vocab_size=len(VOCAB), hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=32,
        max_position_embeddings=32, **kw)


def saved(tmp_path, name, model, **tok_kw):
    mdir = tmp_path / name
    model.save_pretrained(mdir)
    tokenizer(tmp_path, **tok_kw).save_pretrained(mdir)
    return str(mdir)


@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    torch.manual_seed(0)
    tmp = tmp_path_factory.mktemp("bert")
    return saved(tmp, "tiny-bert", transformers.BertModel(bert_config()))


def test_hf_encoder_local_checkpoint(bert_dir):
    """The counterpart of ``tests/test_ir.py::
    test_hf_encoder_local_checkpoint``: a manual mean-pooled forward, batch
    invariance, the corpus flavour — and chamjax's encoder on the same
    directory within 1e-6."""
    enc = HFEncoder(model_name=bert_dir, max_length=16, **CPU)
    q = enc.encode_queries(TEXTS[:3], batch_size=2)
    assert q.shape == (3, 16) and q.dtype == np.float32
    np.testing.assert_allclose(q, enc.encode_queries(TEXTS[:3],
                                                     batch_size=3),
                               atol=1e-5)
    model = transformers.BertModel.from_pretrained(bert_dir).eval()
    tok = transformers.AutoTokenizer.from_pretrained(bert_dir)
    with torch.no_grad():
        e = tok(["dog ran"], return_tensors="pt")
        h = model(**e).last_hidden_state
        mask = e["attention_mask"].unsqueeze(-1)
        ref = ((h * mask).sum(1) / mask.sum(1)).numpy()[0]
    np.testing.assert_allclose(q[1], ref, atol=1e-5)
    docs = [{"title": "the", "text": "cat"}, {"text": "dog"}, "red mat"]
    c = enc.encode_corpus(docs)
    assert c.shape == (3, 16)

    want = JHFEncoder(model_name=bert_dir, max_length=16)
    np.testing.assert_allclose(enc.encode_queries(TEXTS, batch_size=3),
                               want.encode_queries(TEXTS, batch_size=3),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(c, want.encode_corpus(docs), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("num_labels", [1, 2])
def test_hf_cross_encoder_equals_chamjax(tmp_path, num_labels):
    """Both branches of ``predict``: a one-label head's logit and a
    two-label head's last-label probability."""
    torch.manual_seed(1)
    mdir = saved(tmp_path, "tiny-ce", transformers.
                 BertForSequenceClassification(
                     bert_config(num_labels=num_labels)))
    ce = HFCrossEncoder(model_name=mdir, max_length=16, **CPU)
    got = ce.predict(PAIRS, batch_size=3)
    assert len(got) == len(PAIRS)
    want = JHFCrossEncoder(model_name=mdir, max_length=16).predict(
        PAIRS, batch_size=3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if num_labels == 2:
        assert all(0.0 <= s <= 1.0 for s in got)
    # a manual forward of one pair
    model = transformers.BertForSequenceClassification.from_pretrained(
        mdir).eval()
    tok = transformers.AutoTokenizer.from_pretrained(mdir)
    with torch.no_grad():
        logits = model(**tok([PAIRS[0][0]], [PAIRS[0][1]],
                             return_tensors="pt")).logits
    ref = (logits[0, 0] if num_labels == 1
           else torch.softmax(logits, -1)[0, -1]).item()
    assert got[0] == pytest.approx(ref, abs=1e-5)
    # it plugs into Rerank
    corpus = {f"d{i}": {"title": "", "text": t} for i, t in enumerate(TEXTS)}
    first = {"q0": {d: 1.0 for d in corpus}}
    out = Rerank(ce, batch_size=2).rerank(corpus, {"q0": "the red cat"},
                                          first, top_k=2)
    assert len(out["q0"]) == 2


def test_query_generator_equals_chamjax(tmp_path):
    """Sampled generation from a tiny random T5 saved with a BERT
    tokenizer: the same strings as chamjax's generator from the same
    ``torch.manual_seed``."""
    torch.manual_seed(2)
    cfg = transformers.T5Config(
        vocab_size=len(VOCAB), d_model=16, d_kv=8, d_ff=32, num_layers=1,
        num_decoder_layers=1, num_heads=2, decoder_start_token_id=0,
        pad_token_id=0, eos_token_id=VOCAB.index("[SEP]"))
    # T5 takes no token_type_ids: the tokenizer is saved without them
    mdir = saved(tmp_path, "tiny-t5",
                 transformers.T5ForConditionalGeneration(cfg),
                 model_input_names=["input_ids", "attention_mask"])
    gen = QueryGenerator(model_name=mdir, **CPU)
    kw = dict(queries_per_doc=3, max_length=8, top_p=0.95)
    torch.manual_seed(7)
    got = gen.generate(TEXTS[:2], **kw)
    torch.manual_seed(7)
    want = JQueryGenerator(model_name=mdir).generate(TEXTS[:2], **kw)
    assert got == want
    assert len(got) == 2 and all(len(qs) == 3 for qs in got)
    assert all(isinstance(s, str) for qs in got for s in qs)
    assert any(s for qs in got for s in qs)        # not all empty
