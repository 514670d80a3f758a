"""The port's performance model against chamjax's: the same functions with
the same arithmetic, so that equal hardware figures and equal efficiency
constants give equal results; the port's own figures are the H100's and
H200's, and a constant no card measurement has set raises."""

import pytest

from chamjax import perf_model as jpm

from chamjax_torch import perf_model as tpm

# chamjax's default chip, as a GpuSpec (smem_kb has no counterpart: the
# models never read vmem_mb or smem_kb)
V5E_AS_GPU = tpm.GpuSpec(name="v5e", hbm_gbps=jpm.V5E.hbm_gbps,
                         bf16_tflops=jpm.V5E.bf16_tflops,
                         f32_tflops=jpm.V5E.f32_tflops,
                         nvlink_gbps=jpm.V5E.ici_gbps)
CONSTANTS = dict(SCAN_EFF_BF16=0.31, SCAN_EFF_F32=0.17, SELECT_EFF_LOW_RT=0.9,
                 SELECT_EFF_HIGH_RT=0.07, COARSE_SELECT_EFF_SORT=0.05,
                 COARSE_SELECT_EFF_2STAGE=0.4)
MODEL = dict(embed_dim=1024, ffn_embed_dim=4096, layers=12, max_seq_len=512)
SEARCH = dict(dbsize=100_000_000, nlist=65536, nprobe=32, m=16, dim=128,
              batch=128)

# (function name, positional args, keyword args); "spec" is filled in
CASES = {
    "scan_bytes_per_query": ((1_000_000, 4096, 32, 16), {}),
    "scan_qps_roofline": ((1_000_000_000, 65536, 32, 16),
                          dict(efficiency=0.3, spec=None)),
    "lut_flops_per_query": ((32, 16, 8), {}),
    "coarse_flops_per_query": ((65536, 128), {}),
    "padded_rows_per_query": ((100_000_000, 65536, 32), dict(seg=1024)),
    "padded_rows_per_query_windows": ((1_000_000, 4096, 32),
                                      dict(seg=512, windows=48)),
    "search_latency_model": ((), dict(SEARCH, spec=None)),
    "search_latency_model_f32_high_rt": (
        (), dict(SEARCH, spec=None, lut_bf16=False, recall_target=0.99,
                 coarse_2stage=False, windows=64, seg=512)),
    "search_latency_model_given_eff": (
        (), dict(SEARCH, spec=None, scan_efficiency=0.5, mxu_efficiency=0.3)),
    "sharded_merge_bytes": ((100, 8, 128), {}),
    "merge_all_gather_time": ((100, 4, 64), dict(spec=None)),
    "mesh_search_model": ((), dict(SEARCH, n_list_shards=4, dp=2, k=100,
                                   spec=None)),
    "decoder_step_flops": ((1024, 4096, 12, 8, 256), {}),
    "decoder_step_latency": ((1024, 4096, 12, 8, 256), dict(spec=None)),
    "ralm_throughput_model": ((MODEL, 100_000_000, 65536, 32, 16, 128, 64),
                              dict(retrieval_interval=4, spec=None)),
    "ralm_throughput_model_sequential": (
        (MODEL, 10_000_000, 4096, 16, 16, 128, 8),
        dict(tiktok=False, spec=None)),
}


@pytest.fixture
def same_constants(monkeypatch):
    for name, value in CONSTANTS.items():
        monkeypatch.setattr(jpm, name, value)
        monkeypatch.setattr(tpm, name, value)


def _call(module, spec, case):
    args, kw = CASES[case]
    fn = case
    while not hasattr(module, fn):      # case names extend function names
        fn = fn.rsplit("_", 1)[0]
    kw = {k: (spec if k == "spec" else v) for k, v in kw.items()}
    return getattr(module, fn)(*args, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_as_chamjax_on_equal_figures(same_constants, case):
    want = _call(jpm, jpm.V5E, case)
    got = _call(tpm, V5E_AS_GPU, case)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for key in want:
            assert got[key] == pytest.approx(want[key], rel=1e-12), key
    else:
        assert got == pytest.approx(want, rel=1e-12)


def test_hopper_figures():
    h = tpm.H100
    assert (h.hbm_gbps, h.bf16_tflops, h.f32_tflops, h.smem_kb,
            h.nvlink_gbps) == (3350.0, 989.0, 67.0, 227.0, 450.0)
    assert tpm.H200.hbm_gbps == 4800.0
    assert tpm.H200.bf16_tflops == h.bf16_tflops


@pytest.mark.parametrize("name", sorted(CONSTANTS))
def test_unmeasured_constant_raises(monkeypatch, same_constants, name):
    monkeypatch.setattr(tpm, name, None)
    # a latency model that needs this constant: pick the options reading it
    kw = dict(SEARCH, lut_bf16=name != "SCAN_EFF_F32",
              recall_target=0.99 if name == "SELECT_EFF_HIGH_RT" else 0.9,
              coarse_2stage=name != "COARSE_SELECT_EFF_SORT")
    with pytest.raises(ValueError, match=name):
        tpm.search_latency_model(**kw)
    if name.startswith("SCAN_EFF"):     # a given efficiency needs none
        tpm.search_latency_model(**kw, scan_efficiency=0.5)


def test_roofline_ms_picks_the_larger_time():
    ms, by = tpm.roofline_ms(3.35e9, 0)
    assert (ms, by) == (pytest.approx(1.0), "bytes")
    ms, by = tpm.roofline_ms(0, 67e9)
    assert (ms, by) == (pytest.approx(1.0), "operations")
    ms, by = tpm.roofline_ms(1, 989e9, tflops=tpm.H100.bf16_tflops)
    assert (ms, by) == (pytest.approx(1.0), "operations")
    assert tpm.roofline_ms(4.8e9, 0, spec=tpm.H200)[0] == pytest.approx(1.0)
