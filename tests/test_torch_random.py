"""``chamjax_torch.random`` against ``jax.random`` on the CPU, and the
draws built on it (``synthetic_dataset_device``, the flagship's
fingerprint in ``chip_smoke.py``) against the JAX package's.

Every sampler is held bit for bit: keys, ``split``, ``fold_in``, ``bits``
at 32/16/8, float32 and bfloat16 ``uniform``, ``randint``, ``permutation``,
``choice``, ``gumbel`` and both ``normal``s.  The ulp bar of the float32
normal and gumbel is 0: the port evaluates XLA's own CPU ``log``,
``log1p`` and erf_inv polynomials with the same fused multiply-adds.
The plain version runs here (torch ops); the kernel is held against it on
the card (``tests/test_torch_gpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from chamjax.data.datasets import synthetic_dataset_device as j_synthetic

from chamjax_torch import random as jr
from chamjax_torch.data import synthetic_dataset_device

CPU = torch.device("cpu")
SEEDS = (0, 42, 2**31 - 1)


def j_bf16(x) -> np.ndarray:
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in(seed):
    k = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(jr.key(seed), np.asarray(k))
    np.testing.assert_array_equal(jr.as_key(seed), jr.key(seed))
    for num in (2, 3, 5, 64):
        np.testing.assert_array_equal(jr.split(seed, num),
                                      np.asarray(jax.random.split(k, num)))
    for data in (0, 1, 99, 1000, 1_000_000 + 5, 2**32 - 1):
        np.testing.assert_array_equal(
            jr.fold_in(seed, data), np.asarray(jax.random.fold_in(k, data)))
    # chains, and a key given as words
    kk = jax.random.fold_in(jax.random.split(k, 4)[2], 7)
    np.testing.assert_array_equal(
        jr.fold_in(jr.split(seed, 4)[2], 7), np.asarray(kk))
    with pytest.raises(ValueError):
        jr.key(-1)
    with pytest.raises(ValueError):
        jr.fold_in(seed, 2**32)


def test_large_seed_words():
    """A seed past 32 bits fills the hi word (``threefry_seed``)."""
    np.testing.assert_array_equal(jr.key((5 << 32) | 9),
                                  np.array([5, 9], np.uint32))


@pytest.mark.parametrize("width,dtype", [(32, jnp.uint32), (16, jnp.uint16),
                                         (8, jnp.uint8)])
@pytest.mark.parametrize("shape", [(), (7,), (1000, 3), (3, 1, 333)])
def test_bits(width, dtype, shape):
    for seed in SEEDS:
        got = jr.bits(seed, shape, width, device=CPU)
        want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape,
                                          dtype))
        assert got.shape == shape and got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_counter_hi_word():
    """Counters above 2**32: the kernel's plain version against
    ``threefry_2x32`` over counter pairs with a non-zero hi word, and a
    draw crossing 2**32."""
    k = jr.fold_in(3, 17)
    for start in ((1 << 32) - 3, 5 << 32, (1 << 63) + 12345):
        n = 4099
        c = np.arange(start, start + n, dtype=np.uint64)
        hi = (c >> np.uint64(32)).astype(np.uint32)
        lo = (c & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        out = np.asarray(jprng.threefry_2x32(
            jnp.asarray(k), jnp.asarray(np.concatenate([hi, lo]))))
        want = out[:n] ^ out[n:]
        got = jr.threefry_draw_reference(k, n, "u32", start=start,
                                         device=CPU)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (hi != 0).any()


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-3.0, 5.5), (0.1, 0.7),
                                   (-1e-3, 1e-3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_uniform(lo, hi, dtype):
    tdt = getattr(torch, dtype)
    for seed in SEEDS[:2]:
        want = jax.random.uniform(jax.random.PRNGKey(seed), (5001,),
                                  getattr(jnp, dtype), lo, hi)
        got = jr.uniform(seed, (5001,), tdt, lo, hi, device=CPU)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), j_bf16(want))


@pytest.mark.parametrize("lo,hi", [(0, 10), (0, 4096), (-5, 100_000),
                                   (0, 2**31 - 1), (3, 3), (7, 2)])
def test_randint(lo, hi):
    for seed in SEEDS:
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                             (3001,), lo, hi))
        got = jr.randint(seed, (3001,), lo, hi, device=CPU)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    # a scalar draw (k-means++'s first pick) and the uint8 codes of the
    # stage profile's random index, whose span wraps to 0
    k = jax.random.PRNGKey(4)
    assert int(jr.randint(4, (), 0, 777, device=CPU)) == int(
        jax.random.randint(k, (), 0, 777))
    np.testing.assert_array_equal(
        jr.randint(4, (16, 300), 0, 256, torch.uint8, device=CPU).numpy(),
        np.asarray(jax.random.randint(k, (16, 300), 0, 256, jnp.uint8)))


@pytest.mark.parametrize("n", [1, 100, 2**16 + 3])
def test_permutation(n):
    for seed in SEEDS[:2]:
        want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed),
                                                 n))
        np.testing.assert_array_equal(
            jr.permutation(seed, n, device=CPU).numpy(), want)


def test_permutation_in_three_rounds():
    """Past ~2.6M elements ``_shuffle`` sorts three times."""
    n = 2_700_000
    assert int(np.ceil(3 * np.log(n) / np.log(2**32 - 1))) == 3
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(1), n))
    np.testing.assert_array_equal(jr.permutation(1, n, device=CPU).numpy(),
                                  want)


def test_choice():
    for seed in SEEDS[:2]:
        k = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            jr.choice(seed, 5000, 77, device=CPU).numpy(),
            np.asarray(jax.random.choice(k, 5000, (77,), replace=False)))
    with pytest.raises(ValueError):
        jr.choice(0, 5, 6, device=CPU)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(), (1 << 20,), (300, 70)])
def test_normal(dtype, shape):
    """Bit for bit, float32 too (bar: 0 ulps), over a million draws: every
    uniform input of the erf_inv's two branches is reached."""
    tdt = getattr(torch, dtype)
    for seed in SEEDS[:2]:
        want = jax.random.normal(jax.random.PRNGKey(seed), shape,
                                 getattr(jnp, dtype))
        got = jr.normal(seed, shape, tdt, device=CPU)
        assert got.shape == shape and got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), j_bf16(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scaled_normal_is_the_separate_multiply(dtype):
    """``normal(..., scale=s)`` is the reference's ``normal(...) * s`` in
    the draw's dtype (Llama's bf16 init, the corpora's 4.0 and 0.05)."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    k = jax.random.PRNGKey(9)
    for s in (4.0, 0.05, 512 ** -0.5, 1376 ** -0.5):
        want = jax.random.normal(k, (4096,), jdt) * jnp.asarray(s, jdt)
        got = jr.normal(9, (4096,), tdt, scale=s, device=CPU)
        np.testing.assert_array_equal(got.float().numpy(), j_bf16(want))


def test_gumbel():
    """Bit for bit (bar: 0 ulps): ``-log(-log(u))`` with XLA's CPU log."""
    for seed in SEEDS[:2]:
        want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed),
                                            (1 << 20,)))
        np.testing.assert_array_equal(
            jr.gumbel(seed, (1 << 20,), device=CPU).numpy(), want)


def test_float_helpers_are_xla_cpu():
    """The port's log, log1p and erf_inv equal XLA's CPU functions over
    their ranges, bit for bit."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(1e-30, 1, 1 << 16),
                        rng.uniform(0.3, 3, 1 << 16),
                        10 ** rng.uniform(-30, 30, 1 << 16),
                        [0.0, 1.0, np.inf]]).astype(np.float32)
    np.testing.assert_array_equal(jr.log_f32(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.log(x)))
    z = np.concatenate([-rng.uniform(0, 1, 1 << 16) ** 2,
                        rng.uniform(-0.5, 0.5, 1 << 16)]).astype(np.float32)
    np.testing.assert_array_equal(
        jr.log1p_f32(torch.from_numpy(z)).numpy(), np.asarray(jnp.log1p(z)))
    u = np.concatenate([rng.uniform(-1, 1, 1 << 16), [-1.0, 1.0, 0.0],
                        1 - 2.0 ** -rng.integers(2, 24, 64)]
                       ).astype(np.float32)
    np.testing.assert_array_equal(
        jr.erf_inv_f32(torch.from_numpy(u)).numpy(),
        np.asarray(jax.lax.erf_inv(u)))


def test_draws_take_the_card_by_default(monkeypatch):
    """``device=None`` is the card: without one a draw raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for draw in (lambda: jr.normal(0, (4,)), lambda: jr.bits(0, (4,)),
                 lambda: jr.permutation(0, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            draw()


def test_draw_rejects_bad_forms():
    with pytest.raises(ValueError, match="form"):
        jr.threefry_draw(0, 4, "normal_f16", device=CPU)
    with pytest.raises(ValueError, match="width"):
        jr.bits(0, (4,), 64, device=CPU)
    with pytest.raises(ValueError, match="dtype"):
        jr.randint(0, (4,), 0, 9, torch.int64, device=CPU)
    with pytest.raises(ValueError):
        jr.threefry_draw(0, 4, "u32", start=(1 << 64) - 2, device=CPU)


# ---------------------------------------------------------------------------
# synthetic_dataset_device and the flagship's fingerprint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(spectrum_tau=0.0),
    dict(spectrum_tau=4.0),
    dict(parts=("xq", "xb")),
], ids=["isotropic", "spectrum", "parts"])
def test_synthetic_dataset_device_matches_chamjax(kw):
    """nb 4096, d 32, 64 clusters in chunks of 1024 (several a split), each
    split against the JAX package's draw (rtol 1e-5, atol 1e-5: the fp32
    products run in other orders); undrawn splits are None."""
    args = dict(nb=4096, nq=100, nt=3000, d=32, seed=3, n_clusters=64,
                chunk=1024, **kw)
    want = j_synthetic(**args)
    got = synthetic_dataset_device(**args, device=CPU)
    for part in ("xb", "xt", "xq"):
        w, g = getattr(want, part), getattr(got, part)
        if w is None:
            assert g is None, part
            continue
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=part)


def test_synthetic_dataset_device_stays_on_the_device():
    ds = synthetic_dataset_device(nb=2048, nq=4, nt=8, d=16, seed=1,
                                  n_clusters=8, to_host=False, device=CPU)
    assert isinstance(ds.xb, torch.Tensor) and ds.xb.shape == (2048, 16)
    again = synthetic_dataset_device(nb=2048, nq=4, nt=8, d=16, seed=1,
                                     n_clusters=8, chunk=500, device=CPU)
    # chunks start at multiples of ``chunk``: another chunking is another
    # stream, as in the reference
    assert not np.allclose(again.xb, ds.xb.numpy())


def fingerprint(ds) -> dict:
    """Each split's shape, float64 sum, sum of |x| and sum of squares, and
    its first and last 4 rows: ``chip_smoke.py``'s check of the card's
    flagship draw."""
    out = {}
    for part in ("xb", "xt", "xq"):
        x = np.asarray(getattr(ds, part), np.float64)
        out[part] = dict(shape=list(x.shape), sum=float(x.sum()),
                         sum_abs=float(np.abs(x).sum()),
                         sumsq=float((x * x).sum()),
                         head=x[:4], tail=x[-4:])
    return out


def test_flagship_fingerprint_is_chamjax_draw():
    """``chip_smoke.FLAGSHIP_FINGERPRINT`` holds the JAX package's own draw
    of the flagship (``synthetic_dataset_device(**FLAGSHIP)`` on the CPU),
    at the script's bars: the sums within 1e-6 of the sum of |x| (of
    itself for the sum of squares), the rows within 1e-4."""
    import chip_smoke
    got = fingerprint(j_synthetic(**chip_smoke.FLAGSHIP))
    for part, want in chip_smoke.FLAGSHIP_FINGERPRINT.items():
        g = got[part]
        assert g["shape"] == want["shape"], part
        assert abs(g["sum"] - want["sum"]) <= 1e-6 * want["sum_abs"], part
        assert abs(g["sum_abs"] - want["sum_abs"]) <= 1e-6 * want["sum_abs"]
        assert abs(g["sumsq"] - want["sumsq"]) <= 1e-6 * want["sumsq"]
        np.testing.assert_allclose(g["head"], want["head"], rtol=0,
                                   atol=1e-4, err_msg=part)
        np.testing.assert_allclose(g["tail"], want["tail"], rtol=0,
                                   atol=1e-4, err_msg=part)
    assert chip_smoke.fingerprint_errors(got) == []
