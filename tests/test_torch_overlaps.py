"""Label overlaps and the segmentation metrics of the port against the
JAX package, on the CPU.

``count_overlaps`` returns the JAX package's arrays, in the same order,
including uint64 ids above 2^32; ``ContingencyTable.from_arrays`` gives
the same table on the device and on the host, both ways round; the
ignore-aware scores (VI, Rand, CREMI, object VI) agree within 1e-12.
"""

import numpy as np
import pytest
import torch

from cluster_tools_tpu.ops.overlaps import count_overlaps as j_count
from cluster_tools_tpu.utils import validation as jv
from cluster_tools_tpu_torch.ops.overlaps import count_overlaps as p_count
from cluster_tools_tpu_torch.utils import validation as pv

TOL = 1e-12


def _labels(shape, lo, hi, seed, big=False):
    out = np.random.RandomState(seed).randint(lo, hi, size=shape).astype(
        "uint64")
    if big:  # ids above 2^32 (per-block offsets at cluster scale)
        out[out > 0] += np.uint64(2 ** 33 + 12345)
    return out


@pytest.mark.parametrize("shape,a_range,b_range,big", [
    ((6, 7, 8), (0, 5), (0, 9), False),
    ((12, 13), (1, 40), (0, 3), False),
    ((5, 6, 7), (0, 30), (0, 30), True),
    ((1, 40), (0, 2), (7, 8), False),
])
def test_count_overlaps_matches_jax(shape, a_range, b_range, big):
    a = _labels(shape, *a_range, seed=1, big=big)
    b = _labels(shape, *b_range, seed=2, big=big)
    want = j_count(a, b)
    got = p_count(a, b, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint64
        np.testing.assert_array_equal(g, w)
    assert int(got[2].sum()) == a.size


def test_count_overlaps_edge_cases():
    empty = np.zeros((0, 4), "uint64")
    for arr in p_count(empty, empty, device="cpu"):
        assert arr.shape == (0,)
    with pytest.raises(ValueError, match="shape mismatch"):
        p_count(np.zeros((2, 3)), np.zeros((3, 2)), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            p_count(np.zeros((2, 3)), np.zeros((2, 3)))


@pytest.mark.parametrize("swap", [False, True], ids=["gt_seg", "seg_gt"])
def test_contingency_table_on_device_and_host(swap):
    gt = _labels((6, 7, 8), 0, 8, seed=3)
    seg = _labels((6, 7, 8), 0, 9, seed=4, big=True)
    a, b = (seg, gt) if swap else (gt, seg)
    want = jv.ContingencyTable.from_arrays(a, b, on_device=True)
    for t in (pv.ContingencyTable.from_arrays(a, b, on_device=True,
                                              device="cpu"),
              pv.ContingencyTable.from_arrays(a, b, on_device=False)):
        np.testing.assert_array_equal(t.p_ids, want.p_ids)
        np.testing.assert_array_equal(t.p_counts, want.p_counts)
        np.testing.assert_array_equal(t.a_ids, want.a_ids)
        np.testing.assert_array_equal(t.b_counts, want.b_counts)
        assert t.n_points == want.n_points


IGNORES = [(None, None), ([0], None), (None, [0]), ([0], [0]),
           ([0, 3], [2])]


@pytest.mark.parametrize("ignore_seg,ignore_gt", IGNORES)
def test_ignore_aware_scores_match_jax(ignore_seg, ignore_gt):
    gt = _labels((8, 9, 10), 0, 6, seed=5)
    seg = gt.copy()
    seg[seg == 2] = 1                               # a merge
    seg[(gt == 4) & (np.arange(10) % 2 == 0)] = 17  # a split
    noise = np.random.RandomState(6).rand(*gt.shape) < 0.1
    seg[noise] = _labels(gt.shape, 0, 5, seed=7)[noise]
    kw = dict(ignore_seg=ignore_seg, ignore_gt=ignore_gt)
    for name in ("variation_of_information", "rand_index", "cremi_score"):
        got = getattr(pv, name)(seg, gt, **kw)
        want = getattr(jv, name)(seg, gt, **kw)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    got, want = pv.object_vi(seg, gt, **kw), jv.object_vi(seg, gt, **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL)
    mask_p = pv.compute_ignore_mask(seg, gt, ignore_seg, ignore_gt)
    mask_j = jv.compute_ignore_mask(seg, gt, ignore_seg, ignore_gt)
    assert (mask_p is None) == (mask_j is None)
    if mask_j is not None:
        np.testing.assert_array_equal(mask_p, mask_j)
    # the pair-level drop equals voxel masking
    table = pv.drop_ignored_pairs(pv.ContingencyTable.from_arrays(gt, seg),
                                  ignore_a=ignore_gt, ignore_b=ignore_seg)
    np.testing.assert_allclose(pv.compute_vi_scores(table),
                               pv.variation_of_information(seg, gt, **kw),
                               rtol=0, atol=TOL)
