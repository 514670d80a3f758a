"""chamjax_torch.eval.tie_mismatches: what counts as a tie and what does
not, on hand-made top-k rows."""

import numpy as np
import pytest

from chamjax_torch.eval import tie_mismatches

D = np.array([[1.0, 2.0, 2.0, 3.0, 4.0],
              [0.5, 1.5, 2.5, 2.5, 2.5]], np.float32)
I = np.array([[10, 11, 12, 13, 14],
              [20, 21, 22, 23, 24]], np.int64)
INF = np.float32(np.inf)


def edit(d=None, i=None, **at):
    """Copies of D and I with entries replaced: ``at`` maps 'd'/'i' to
    lists of ((row, rank), value)."""
    d2, i2 = D.copy() if d is None else d, I.copy() if i is None else i
    for (r, c), v in at.get("dv", []):
        d2[r, c] = v
    for (r, c), v in at.get("iv", []):
        i2[r, c] = v
    return d2, i2


CASES = {
    # name: (edits, faults expected)
    "identical": ({}, False),
    "tie_swapped": ({"iv": [((0, 1), 12), ((0, 2), 11)]}, False),
    "boundary_class_reordered": ({"iv": [((1, 2), 24), ((1, 4), 22)]}, False),
    "boundary_id_unseen": ({"iv": [((1, 3), 99)]}, False),
    "unique_rank_swapped": ({"iv": [((0, 0), 13), ((0, 3), 10)]}, True),
    "unique_rank_replaced": ({"iv": [((1, 1), 99)]}, True),
    "tie_class_replaced": ({"iv": [((0, 2), 99)]}, True),
    "boundary_id_from_elsewhere": ({"iv": [((1, 4), 20)]}, True),
    "boundary_id_twice": ({"iv": [((1, 3), 99), ((1, 4), 99)]}, True),
    "dist_off": ({"dv": [((0, 3), 3.1)]}, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_tie_mismatches(name):
    edits, faulty = CASES[name]
    d, i = edit(**edits)
    bad = tie_mismatches(d, i, D, I, rtol=1e-5, atol=1e-5)
    assert bool(bad) == faulty, bad


def test_padding_and_shapes():
    d = np.array([[1.0, 2.0, INF, INF]], np.float32)
    i = np.array([[5, 6, -1, -1]], np.int64)
    assert tie_mismatches(d, i, d.copy(), i.copy(), rtol=1e-5, atol=0) == []
    assert tie_mismatches(d[:, :3], i[:, :3], d, i, rtol=1e-5, atol=0)
    # a missing candidate before the padding is not a tie
    i2 = i.copy()
    i2[0, 1] = 7
    assert tie_mismatches(d, i2, d, i, rtol=1e-5, atol=0)


def test_near_tie_in_either_result():
    """Two ranks within rounding of each other in the result under test
    form a class even where the reference separates them slightly."""
    d_ref = np.array([[1.0, 1.00003, 3.0]], np.float32)
    d = np.array([[1.000015, 1.000015, 3.0]], np.float32)
    i_ref = np.array([[1, 2, 3]], np.int64)
    i = np.array([[2, 1, 3]], np.int64)
    assert tie_mismatches(d, i, d_ref, i_ref, rtol=2e-5, atol=0) == []
    # the same swap where neither result has the two ranks within rounding
    assert tie_mismatches(d_ref, i, d_ref, i_ref, rtol=2e-5, atol=0)
