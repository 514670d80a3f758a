"""``work.py``'s operation and byte counts against hand counts."""

import json

import pytest

from portbench import work
from portbench.spec import HERE


def _cfg(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_dec_s_step_by_hand():
    m = _cfg("dec-s")["model"]
    ops, nbytes = work.decoder_step(m, b=64, held=255)
    d, f, L, V = 512, 2048, 24, 50000
    layer_w = 4 * d * d + 2 * d * f            # 3,145,728 elements
    assert ops["bf16"] == (2 * 64 * L * layer_w + 2 * 64 * d * V
                           + 2 * 64 * L * d * 256)
    assert ops["f32"] == 2 * 64 * L * d * 256
    weights = L * (layer_w + 5 * d + f) + d * V + 2 * d
    assert weights == 101_209_088
    kv = 2 * L * 64 * 255 * d * 2              # 802 MB of K and V read
    assert nbytes == (weights + 2 * 64 * d) * 2 + kv \
        + 2 * L * 64 * d * 2 + 64 * V * 2
    # memory bound: about 1.0 GB, 0.30 ms at 3.35 TB/s
    assert work.least_s(ops, nbytes) == pytest.approx(nbytes / 3.35e12)
    assert 0.29e-3 < work.least_s(ops, nbytes) < 0.32e-3


def test_encdec_s_step_and_refill_by_hand():
    m = _cfg("encdec-s")["model"]
    d, f, L, b, s = 512, 2048, 24, 64, 512
    ops, nbytes = work.decoder_step(m, b=b, held=0, cross_len=s)
    plain_ops, plain_bytes = work.decoder_step(m, b=b, held=0)
    assert nbytes - plain_bytes == (L * (2 * d * d + 2 * d) * 2
                                    + 2 * L * b * s * d * 2)
    assert ops["f32"] - plain_ops["f32"] == 2 * b * L * d * s
    r_ops, r_bytes = work.cross_refill(m, b=b, s=s)
    enc_layer = 4 * d * d + 2 * d * f
    assert r_ops["bf16"] == (2 * b * 1 * 2 * enc_layer + 2 * b * 2 * 1 * d
                             + 2 * b * s * 2 * enc_layer
                             + 2 * b * 2 * s * s * d
                             + 2 * b * s * L * d * 2 * d)
    assert r_ops["f32"] == 2 * b * 2 * 1 * d + 2 * b * 2 * s * s * d
    # the cross K/V written once: 1.6 GB
    assert r_bytes > 2 * L * b * s * d * 2 == 1_610_612_736


def test_search_batch_and_scan_by_hand():
    c = _cfg("dec-s")
    ix = {**c["index"], **c["search"]}
    ops, nbytes = work.search_batch(ix, b=128, rows_probed=1_000_000,
                                    union_rows=600_000, k=10)
    assert ops["f32"] == (2 * 128 * 512 * 4096 + 2 * 128 * 32 * 256 * 512
                          + 1_000_000 * 16)
    assert nbytes == (600_000 * 16 + (4096 * 512 + 256 * 512 + 128 * 512) * 4
                      + 128 * 10 * 8)
    # the f32 LUT and coarse GEMMs bound it: 1.62 GFLOP at 67 TFLOP/s
    assert work.least_s(ops, nbytes) == pytest.approx(ops["f32"] / 67e12)
    s_ops, s_bytes = work.scan(ix, b=128, rows_probed=1_000_000,
                               union_rows=600_000, lut_bytes=2)
    assert s_ops["f32"] == 16_000_000
    assert s_bytes == 600_000 * 16 + 128 * 32 * 16 * 256 * 2
