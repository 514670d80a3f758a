"""``chamjax_torch.benchmarks.scan_timing`` on the CPU at a small size: every
timed call agrees with its plain version and has a bound (the wrappers run
their plain versions on CPU tensors; the card runs the kernels)."""

import pytest
import torch

from chamjax_torch.benchmarks import scan_timing


@pytest.fixture(scope="module")
def small():
    """The flagship's shapes cut to 4 queries x 8 probes over 64 lists."""
    with pytest.MonkeyPatch.context() as mp:
        for name, value in dict(B=4, NPROBE=8, NLIST=64, NB=64 * 244).items():
            mp.setattr(scan_timing, name, value)
        yield scan_timing.flagship_inputs(torch.device("cpu"))


@pytest.mark.parametrize("kernel", [
    "adc_scan_tiles", "adc_scan_segments_multi", "adc_scan_segments",
    "adc_scan_distances", "adc_scan_tiles@seg2048",
    "adc_scan_distances@scan4096"])
def test_calls_agree_with_plain_versions(small, kernel):
    fn, ref, bound = scan_timing.calls(small)[kernel]
    got = fn()
    assert scan_timing.check(kernel, got, ref()) == 0.0
    ms, by = bound(got)
    assert ms > 0 and by == "bytes"


def test_check_catches_a_wrong_distance(small):
    fn, ref, _ = scan_timing.calls(small)["adc_scan_tiles"]
    want = ref()
    got = want.clone()
    got[torch.isfinite(got).nonzero()[0].tolist()] += 1.0
    with pytest.raises(AssertionError):
        scan_timing.check("adc_scan_tiles", got, want)
