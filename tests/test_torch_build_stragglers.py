"""The balanced streamed build's stragglers on the hard-mode corpus: the
corpus drawn in one 2^20-row chunk with 4×nlist clusters (seed 11), built
hard-capped at 1.3× the mean list length with 8 k-means and 12
balanced-Lloyd iterations over the whole corpus as the training sample.
Prints one line a build: stragglers, the longest list and the cap.  A
script (minutes on the CPU): pytest collects no test from it.

    python tests/test_torch_build_stragglers.py D NLIST          # e.g. 128 1024
        the JAX package against the port, both on the CPU, each drawing
        its own stream of the same corpus family;
    python tests/test_torch_build_stragglers.py D NLIST --card
        the port alone on the card, with its bf16 stage-1 shortlist and
        again with an fp32 one (no JAX import: the card's machine has none).
"""

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

GEN = 1 << 20
KW = dict(kmeans_iters=8, pq_iters=2, chunk=GEN, block=4096)
CFG = dict(m=8, list_pad=128, balanced=True, balance_hard=True,
           balance_factor=1.3)


def report(name, d, nlist, info, t0):
    print(f"{name} d={d} nlist={nlist} rows={GEN}: stragglers "
          f"{info['stragglers']} ({info['stragglers'] / GEN:.4%}), max list "
          f"{int(info['list_len'].max())}, cap {info['cap']}, "
          f"{time.time() - t0:.0f} s", flush=True)


def port_build(d, nlist, device):
    from chamjax_torch.config import IndexConfig
    from chamjax_torch.data.hard import make_hard_corpus
    from chamjax_torch.index.device_build import build_ivfpq_device
    hc = make_hard_corpus(d=d, n_clusters=4 * nlist, seed=11, device=device)
    return build_ivfpq_device(hc.draw_base, GEN,
                              IndexConfig(dim=d, nlist=nlist, **CFG),
                              hc.draw_train(0, GEN), device=device, **KW)[1]


def on_cpu(d, nlist):
    import jax
    jax.config.update("jax_platforms", "cpu")
    from chamjax.config import IndexConfig
    from chamjax.data.hard import make_hard_corpus
    from chamjax.index.device_build import build_ivfpq_device
    t0 = time.time()
    hc = make_hard_corpus(d=d, n_clusters=4 * nlist, seed=11)
    info = build_ivfpq_device(hc.draw_base, GEN,
                              IndexConfig(dim=d, nlist=nlist, **CFG),
                              hc.draw_train(0, GEN), **KW)[1]
    report("jax", d, nlist, info, t0)
    t0 = time.time()
    report("torch", d, nlist, port_build(d, nlist, "cpu"), t0)


def on_card(d, nlist):
    import torch
    from chamjax_torch.index import device_build as db
    from chamjax_torch.utils.precision import fp32_matmul
    bf16 = db._stage1_scores

    def fp32(x, cent):
        with fp32_matmul():
            return torch.mm(x, cent.T).mul_(2.0).sub_(
                torch.sum(cent * cent, dim=1)[None, :])

    dev = torch.device("cuda", 0)
    for name, stage1 in (("torch card bf16 stage 1", bf16),
                         ("torch card fp32 stage 1", fp32)):
        db._stage1_scores = stage1
        t0 = time.time()
        info = port_build(d, nlist, dev)
        torch.cuda.synchronize()
        report(name, d, nlist, info, t0)
    db._stage1_scores = bf16


if __name__ == "__main__":
    (on_card if "--card" in sys.argv else on_cpu)(int(sys.argv[1]),
                                                  int(sys.argv[2]))
