"""Recall-loss decomposition (``chamjax_torch.eval.diagnose``) on the CPU:
the counterparts of ``tests/test_diagnose.py`` over the port's own search,
and parity with ``chamjax.eval.diagnose`` — one index built by chamjax,
carried across, searched by chamjax's ``backend="xla"`` route, and both
packages' diagnoses fed the same ids and distances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chamjax.config import IndexConfig
from chamjax.data import synthetic_dataset
from chamjax.data.ground_truth import compute_ground_truth
from chamjax.eval.diagnose import recall_diagnosis as j_recall_diagnosis
from chamjax.index import build_ivfpq
from chamjax.searcher import DeviceIVF as JDeviceIVF
from chamjax.searcher import ivfpq_search as j_ivfpq_search

from chamjax_torch.eval import recall_diagnosis
from chamjax_torch.eval.diagnose import _adc_of_rows
from chamjax_torch.searcher import DeviceIVF, auto_seg, auto_windows
from chamjax_torch.searcher import ivfpq_search

from test_torch_layout import carry

KEYS = ("found", "probe", "window", "quant", "select")


@pytest.fixture(scope="module")
def setup():
    # few broad clusters over 64 lists: ground truth spreads across
    # several lists, so probe/window losses are actually exercised
    ds = synthetic_dataset(nb=20_000, nq=32, nt=6000, d=32, seed=9,
                           n_clusters=4)
    idx = build_ivfpq(ds.xb, IndexConfig(dim=32, nlist=64, m=8, list_pad=64),
                      xt=ds.xt, kmeans_iters=6, pq_iters=6)
    dev = DeviceIVF.from_packed(carry(idx), device="cpu")
    gt, _ = compute_ground_truth(ds.xb, ds.xq, k=10)
    return ds, idx, dev, gt


def _run(dev, xq, nprobe, windows, seg, k=10):
    d, i = ivfpq_search(dev, torch.from_numpy(xq), nprobe=nprobe, k=k,
                        windows=windows, seg=seg, group=2, use_approx=False,
                        backend="seg")
    return d.numpy(), i.numpy().astype(np.int64)


# --- counterparts of tests/test_diagnose.py ------------------------------------


def test_classes_partition_and_sum_to_one(setup):
    ds, idx, dev, gt = setup
    seg = auto_seg(idx.list_len)
    W = auto_windows(idx.list_len, seg, 16)
    dists, ids = _run(dev, ds.xq, 16, W, seg)
    diag = recall_diagnosis(dev, ds.xq, gt, ids, dists, nprobe=16,
                            windows=W, seg=seg, group=2, at=10)
    assert abs(sum(diag.values()) - 1.0) < 1e-9
    assert 0.1 <= diag["found"] <= 1.0
    # found must equal the gt∩result intersection fraction
    inter = np.mean([np.isin(gt[i, :10], ids[i]).mean()
                     for i in range(gt.shape[0])])
    assert diag["found"] == pytest.approx(float(inter))


def test_probe_loss_shrinks_with_more_probes(setup):
    ds, idx, dev, gt = setup
    seg = auto_seg(idx.list_len)
    out = {}
    for nprobe in (2, 16):
        W = auto_windows(idx.list_len, seg, nprobe)
        dists, ids = _run(dev, ds.xq, nprobe, W, seg)
        out[nprobe] = recall_diagnosis(dev, ds.xq, gt, ids, dists,
                                       nprobe=nprobe, windows=W, seg=seg,
                                       group=2)
    assert out[2]["probe"] > out[16]["probe"]
    assert out[16]["probe"] <= 0.05


def test_window_loss_appears_when_budget_starved(setup):
    ds, idx, dev, gt = setup
    seg = auto_seg(idx.list_len)
    W_full = auto_windows(idx.list_len, seg, 16)
    W_tiny = max(3, W_full // 8) | 1   # odd: group round-up bites
    dists, ids = _run(dev, ds.xq, 16, W_tiny, seg)
    diag = recall_diagnosis(dev, ds.xq, gt, ids, dists, nprobe=16,
                            windows=W_tiny, seg=seg, group=2)
    # the scan rounds W up to a group multiple — the diagnosis must mirror
    # that, so reach with group=2 is a superset of the group=1 reckoning
    diag_g1 = recall_diagnosis(dev, ds.xq, gt, ids, dists, nprobe=16,
                               windows=W_tiny, seg=seg, group=1)
    assert diag["window"] <= diag_g1["window"] + 1e-12
    full_d, full_i = _run(dev, ds.xq, 16, W_full, seg)
    full = recall_diagnosis(dev, ds.xq, gt, full_i, full_d, nprobe=16,
                            windows=W_full, seg=seg, group=2)
    assert diag["window"] > full["window"]
    assert full["window"] <= 0.02


# --- parity with chamjax ---------------------------------------------------------


@pytest.fixture(scope="module")
def xla_results(setup):
    """chamjax's xla search (no Pallas) at nprobe 8 over the setup index,
    with a starved window budget for the diagnoses."""
    ds, idx, _dev, _gt = setup
    jdev = JDeviceIVF.from_packed(idx)
    nprobe = 8
    d, i = j_ivfpq_search(jdev, jnp.asarray(ds.xq), nprobe=nprobe, k=10,
                          scan_len=idx.suggest_scan_len(nprobe),
                          backend="xla", use_approx=False)
    seg = auto_seg(idx.list_len)
    W = max(3, auto_windows(idx.list_len, seg, nprobe) // 4) | 1
    return jdev, np.asarray(d), np.asarray(i).astype(np.int64), nprobe, W, seg


@pytest.mark.parametrize("group, coarse_cand", [(1, 0), (2, 0), (2, 16)],
                         ids=["g1", "g2", "g2_shortlist"])
def test_diagnosis_equals_chamjax(setup, xla_results, group, coarse_cand):
    """Equal dicts.  A missed item may land in another class only where
    its ADC lies within rtol 1e-5 of its query's k-th distance (the two
    packages sum the ADC in another order); the allowance is the count of
    such items, and it is 0 on this index."""
    ds, _idx, dev, gt = setup
    jdev, dists, ids, nprobe, W, seg = xla_results
    kw = dict(nprobe=nprobe, windows=W, seg=seg, group=group,
              coarse_cand=coarse_cand)
    got = recall_diagnosis(dev, ds.xq, gt, ids, dists, **kw)
    want = j_recall_diagnosis(jdev, ds.xq, gt, ids, dists, **kw)
    assert set(got) == set(want) == set(KEYS)
    for key in ("probe", "window", "quant"):
        assert want[key] > 0, (key, want)     # every class is exercised
    # the borderline items: ADC within rtol 1e-5 of the k-th distance
    inv = {int(v): r for r, v in enumerate(dev.ids.numpy()) if v >= 0}
    rows = torch.tensor([[inv[int(g)] for g in row] for row in gt[:, :10]])
    list_of = torch.searchsorted(dev.list_start.long(), rows, right=True) - 1
    adc = _adc_of_rows(dev, torch.from_numpy(ds.xq), rows, list_of).numpy()
    kth = dists[:, -1:]
    missed = ~(ids[:, :, None] == gt[:, None, :10]).any(1)
    borderline = int((missed & (np.abs(adc - kth)
                                <= 1e-5 * np.abs(kth))).sum())
    assert borderline == 0
    total = gt[:, :10].size
    for key in KEYS:
        assert abs(got[key] - want[key]) * total <= borderline, (key, got,
                                                                 want)
    assert got == want
