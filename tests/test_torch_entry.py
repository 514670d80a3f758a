"""The entry points (``chamjax_torch/entry.py``: ``entry``,
``dryrun_multichip``) and the mesh (``parallel/mesh.py``) against the JAX
package's (``__graft_entry__.py``, ``chamjax/parallel/mesh.py``), on the
CPU: the JAX package on its 8 virtual CPU devices, the port on meshes of
CPU positions.  Without a card and without ``devices``, the port's
entry points raise: nothing moves to the CPU on its own.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from chamjax.parallel import make_mesh as j_make_mesh

from chamjax_torch import entry as tentry
from chamjax_torch.eval import tie_mismatches
from chamjax_torch.parallel import all_gather_to, all_reduce_sum, make_mesh
from chamjax_torch.searcher import auto_seg, auto_windows, ivfpq_search


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


def test_entry_step_on_cpu():
    """``entry()``'s step: the JAX package's output shapes, and the
    multi-window scan equal to the single-window one on the same index
    (ids up to ties; both packed-bf16)."""
    jfn, jargs = graft.entry()
    jd, ji = jfn(*jargs)
    fn, (index, q) = tentry.entry(device="cpu")
    d, i = fn(index, q)
    assert tuple(d.shape) == jd.shape and tuple(i.shape) == ji.shape
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    ll = index.list_len.numpy()
    seg = auto_seg(ll)
    w = auto_windows(ll, seg, 8)
    d1, i1 = ivfpq_search(index, q, nprobe=8, k=10, seg=seg, group=1,
                          windows=w + (-w) % 4, backend="seg", lut_bf16=True)
    bad = tie_mismatches(d.numpy(), i.numpy().astype(np.int64), d1.numpy(),
                         i1.numpy().astype(np.int64), rtol=1e-5, atol=1e-5)
    assert not bad, bad
    assert bool(torch.isfinite(d).all()) and bool((i >= 0).all())


@pytest.mark.parametrize("n_devices", [8, 6, 3])
def test_dryrun_multichip_on_cpu_positions(n_devices, capsys):
    """The port's dryrun on ``["cpu"] * n`` with the JAX package's layout
    rule (its printed mesh) and outputs."""
    graft.dryrun_multichip(n_devices)
    printed = capsys.readouterr().out
    axes = tentry.mesh_axes(n_devices)
    assert f"mesh={axes}" in printed
    out = tentry.dryrun_multichip(n_devices, devices=["cpu"] * n_devices)
    assert out["mesh"] == dict(axes)
    assert out["distinct_devices"] == 1 and not out["captured"]
    assert out["tokens"] == [4] and out["topk"] == [4, 5]


def test_dryrun_multichip_needs_cards_or_devices(no_card):
    with pytest.raises(RuntimeError, match="0 present"):
        tentry.dryrun_multichip(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((("lists", 2),))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((("lists", 2),), devices=["cuda:0", "cuda:0"])


@pytest.mark.parametrize("axes,n", [
    ((("lists", 8),), 8), ((("data", 2), ("lists", -1)), 8),
    ((("dp", 2), ("tp", 2), ("lists", 2)), 8), (None, 4)])
def test_make_mesh_matches_jax(axes, n):
    jm = j_make_mesh(axes, devices=jax.devices()[:n])
    m = make_mesh(axes, devices=["cpu"] * n)
    assert m.shape == dict(jm.shape)
    assert m.axis_names == tuple(jm.axis_names)
    assert m.size == n and m.one_device
    assert m.device_at() == torch.device("cpu")


def test_make_mesh_refuses_sizes_that_do_not_multiply():
    with pytest.raises(ValueError, match="do not multiply"):
        make_mesh((("data", 3), ("lists", 2)), devices=["cpu"] * 8)
    with pytest.raises(AssertionError):
        j_make_mesh((("data", 3), ("lists", 2)), devices=jax.devices()[:8])


def test_collectives_on_cpu_positions():
    parts = [torch.full((2, 3), float(j + 1), dtype=torch.bfloat16)
             for j in range(3)]
    out = all_reduce_sum(parts, [torch.device("cpu")] * 2)
    assert len(out) == 2 and out[0].dtype == torch.float32
    assert torch.equal(out[0], torch.full((2, 3), 6.0))
    got = all_gather_to(parts, torch.device("cpu"))
    assert all(g is p for g, p in zip(got, parts))   # no copy where it lies
