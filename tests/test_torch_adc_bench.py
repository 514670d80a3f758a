"""The host ADC microbenchmark (``chamjax_torch/native/src/adc_bench.cpp``,
a copy of the JAX package's): its source, its build under a hash of source
and flags, and a short run that prints three positive rates.  The rates are
this host's, never a card figure."""

import shutil
from pathlib import Path

import pytest

from chamjax_torch import native

REPO = Path(__file__).resolve().parents[1]


def test_adc_bench_source_is_a_verbatim_copy():
    src = (native.SRC_DIR / native.ADC_BENCH).read_text().splitlines()
    want = (REPO / "chamjax" / "native" / "src" / "adc_bench.cpp"
            ).read_text().splitlines()
    assert "chamjax/native/src/adc_bench.cpp" in src[0]
    assert src[1:] == want
    # a standalone program: not a part of the library
    assert native.ADC_BENCH not in native.SOURCES


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: adc_bench is built with g++")


def test_adc_bench_builds_and_prints_three_rates(gxx):
    rates = native.run_adc_bench(n_rows=1 << 16, m=16)
    assert set(rates) == {"scalar", "unrolled", "soa"}
    assert all(r > 0 for r in rates.values()), rates
    exe = native.build_adc_bench()
    assert exe.exists() and exe.parent == native.BUILD_DIR
    assert exe.name.startswith("adc_bench-")
    assert native.build_adc_bench() == exe     # built once


def test_adc_bench_name_hashes_source_and_flags(monkeypatch, tmp_path):
    """An edit to the flags or the source names another program; a failing
    compiler raises instead of skipping."""
    name = native._hashed("adc_bench", native.ADC_BENCH_FLAGS,
                          (native.ADC_BENCH,))
    monkeypatch.setattr(native, "ADC_BENCH_FLAGS",
                        native.ADC_BENCH_FLAGS + ("-g",))
    assert native._hashed("adc_bench", native.ADC_BENCH_FLAGS,
                          (native.ADC_BENCH,)) != name
    monkeypatch.setattr(native, "ADC_BENCH_FLAGS", ("--no-such-flag",))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    with pytest.raises(native.NativeUnavailable, match="adc_bench"):
        native.build_adc_bench()
