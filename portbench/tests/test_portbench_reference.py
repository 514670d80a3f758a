"""The plain references against the port on tiny configurations on the
CPU: the decoder's step logits, the encoder, the cross K/V and the
search's answers."""

import numpy as np
import torch

from portbench import inputs, program
from portbench.reference import model as ref
from portbench.reference import search as ref_search
from portbench.tests import tiny

CPU = torch.device("cpu")


def _cfg(model_type="decoder"):
    m = dict(tiny.MODEL)
    if model_type == "encoder-decoder":
        m.update(model_type=model_type, encoder_layers=1,
                 retrieval_interval=4, retrieval_token_len=8)
    return {"model": m, "index": tiny.INDEX, "search": tiny.SEARCH}


def test_decoder_steps_match_reference_forward():
    from chamjax_torch.models.transformer import decoder_step, init_kv_cache
    cfg = _cfg()
    w = inputs.make_weights(cfg["model"], 5, CPU, torch.float32)
    p = program.params(cfg, w["decoder"], False, CPU)
    mc = program.model_config(cfg)
    tokens = torch.randint(1, mc.vocab_size, (3, 10), dtype=torch.int32)
    cache = init_kv_cache(mc, 3, device=CPU)
    got = []
    for t in range(10):
        logits, _, cache = decoder_step(p, tokens[:, t], cache,
                                        mc.attention_heads)
        got.append(logits)
    want, _ = ref.decode(w["decoder"], tokens, mc.attention_heads)
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_encoder_and_cross_attention_match_reference():
    from chamjax_torch.models.transformer import (build_cross_kv,
                                                  decoder_step,
                                                  encoder_forward,
                                                  init_kv_cache)
    cfg = _cfg("encoder-decoder")
    mc = program.model_config(cfg)
    w = inputs.make_weights(cfg["model"], 6, CPU, torch.float32)
    enc = program.params(cfg, w["encoder"], True, CPU)
    dec = program.params(cfg, w["decoder"], False, CPU)
    ret = torch.randint(1, mc.vocab_size, (2, 12), dtype=torch.int32)
    e_got = encoder_forward(enc, ret, mc.attention_heads)
    e_want = ref.encode(w["encoder"], ret, mc.attention_heads)
    np.testing.assert_allclose(e_got.numpy(), e_want.numpy(), rtol=1e-4,
                               atol=1e-5)
    ck, cv = build_cross_kv(dec, e_got, mc.attention_heads)
    rk, rv = ref.cross_kv(w["decoder"], e_want)
    np.testing.assert_allclose(ck.reshape(rk.shape).numpy(), rk.numpy(),
                               rtol=1e-4, atol=1e-5)
    tokens = torch.randint(1, mc.vocab_size, (2, 5), dtype=torch.int32)
    cache = init_kv_cache(mc, 2, device=CPU)
    got = []
    for t in range(5):
        logits, _, cache = decoder_step(dec, tokens[:, t], cache,
                                        mc.attention_heads,
                                        cross_kv=(ck, cv))
        got.append(logits)
    want, _ = ref.decode(w["decoder"], tokens, mc.attention_heads,
                         cross=(rk, rv))
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), want.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_retrieved_tokens_match_the_loops_hash():
    from chamjax_torch.serving.ralm import _ids_to_tokens_device
    ids = torch.tensor([[0, 5, 999_999, -1], [7, 2 ** 31 - 1, 3, 11]],
                       dtype=torch.int32)
    got = _ids_to_tokens_device(ids, 16, 50000)[:, :50]
    want = ref.retrieved_tokens(ids, 16, 50000, 50)
    assert torch.equal(got.long(), want)


def test_search_answers_judge_clean_and_broken_ones_do_not():
    cfg = _cfg()
    retriever, tables, xq = program.build(cfg, 9, CPU, queries=64)
    ix = ref_search.Index.from_tables(tables, 4, 4, 8, CPU)
    q = xq[:32]
    res = retriever.retrieve_device(q, 4, 4)
    clean = ref_search.judge(ix, q, res.ids, res.dists)
    assert clean["dist_err"] < 1e-5 and clean["miss"] < 1e-5
    wrong = res.ids.clone()
    wrong[3, 0] = wrong[4, 0]
    assert ref_search.judge(ix, q, wrong, res.dists)["dist_err"] > 1e-3
    far = res.dists.clone()
    far[:, -1] *= 1.01
    assert ref_search.judge(ix, q, res.ids, far)["dist_err"] > 1e-3
    xb = program.corpus(cfg, 9, CPU)
    rows = torch.arange(0, xb.shape[0], 16)
    assert ref_search.encode_gap(ix, xb[rows], rows) < 1e-6
    assert ref_search.id_coverage(ix, tables["ntotal"]) == 0
    t = ref_search.truth(xb, q, res.ids)
    assert torch.isfinite(t["kth_excess"]).all()
    assert float(t["recall"].mean()) > 0.2
    dup = res.ids.clone()
    dup[0, 1] = dup[0, 0]
    assert ref_search.truth(xb, q, dup)["kth_excess"][0] == float("inf")


def test_exact_knn_is_brute_force():
    g = torch.Generator().manual_seed(4)
    xb = torch.randn(3000, 24, generator=g)
    q = torch.randn(7, 24, generator=g)
    rows, d = ref_search.exact_knn(xb, q, 5, chunk=512, spare=4)
    full = ((xb.double()[None] - q.double()[:, None]) ** 2).sum(-1)
    want_d, want = torch.topk(full, 5, dim=1, largest=False)
    assert torch.equal(rows, want)
    torch.testing.assert_close(d, want_d)
    t = ref_search.truth(xb, q, want)
    assert float(t["kth_excess"].abs().max()) == 0.0
    assert float(t["recall"].min()) == 1.0
    far = torch.topk(full, 5, dim=1).indices
    assert float(ref_search.truth(xb, q, far)["kth_excess"].min()) > 0.5
