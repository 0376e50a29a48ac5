"""The scan-based sweep ops of the port (``ops/sweep.py``) against the JAX
package, on the CPU.

Every test of ``tests/test_sweep.py`` runs on the port here, with its
properties (seeds kept, full coverage, the flood's interior agreement
above 0.97, scipy's partition); beside them the JAX functions on the
same inputs (the instance's labels plain, masked and size-filtered, the
wrapper's, the components, the codes) are held equal.  The directional
scans bracket their pairs as ``jax.lax.associative_scan`` does, which
decides the packed-cost ties, so equality is expected.  The
JAX references are jitted ``while_loop``s, computed once per module at
``tests/test_sweep.py``'s ``(24, 48, 48)``."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from cluster_tools_tpu.ops import sweep as J  # noqa: E402
from cluster_tools_tpu_torch.ops import sweep as P  # noqa: E402
from tests.test_sweep import _height_and_seeds, _instance  # noqa: E402


@pytest.fixture(scope="module")
def inst():
    bnd, _ = _instance()
    hq, seeds, fg = _height_and_seeds(bnd)
    return bnd, hq, seeds, fg


@pytest.fixture(scope="module")
def jax_ws(inst):
    """The JAX package's labels on the instance: plain, with the size
    filter, and with a random mask."""
    _, hq, seeds, _ = inst
    mask = np.random.RandomState(3).rand(*hq.shape) < 0.9
    out = {"mask": mask}
    out["plain"] = J.sweep_watershed_impl(
        jnp.asarray(hq), jnp.asarray(seeds), None, max_rounds=64)
    out["min_size"] = J.sweep_watershed_impl(
        jnp.asarray(hq), jnp.asarray(seeds), None, max_rounds=64,
        min_size=100, k_cap=int(seeds.max()) + 1)
    out["masked"] = J.sweep_watershed_impl(
        jnp.asarray(hq), jnp.asarray(seeds), jnp.asarray(mask),
        max_rounds=64)
    return {k: (np.asarray(v[0]), bool(v[1])) if k != "mask" else v
            for k, v in out.items()}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# the scan itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 5, 8, 13, 58])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_brackets_as_jax(n, reverse):
    """A NON-associative operator exposes the bracketing: the port's scan
    must give jax.lax.associative_scan's result on it, forward and
    reverse, for even and odd lengths.  The front combines with the right
    operand's metadata, which the scan carries level by level: a second
    leaf of the JAX scan, here a non-associative metadata combine too."""
    rng = np.random.RandomState(n)
    x = rng.randint(0, 9, (3, n, 2)).astype("int32")
    y = rng.randint(0, 9, (3, n, 2)).astype("int32")

    def f(a, b, mb):
        return (a * 7 + b * 3 + mb + 1) % 101

    def g(ma, mb):
        return (ma * 5 + mb * 2) % 37

    want = jax.lax.associative_scan(
        lambda l, r: (f(l[0], r[0], r[1]), g(l[1], r[1])),
        (jnp.asarray(x), jnp.asarray(y)), axis=1, reverse=reverse)[0]
    sweep = P._Sweep(lambda l, r: [g(l[0], r[0])], [_t(y).long()], 1,
                     reverse)
    got = sweep(lambda l, r, m: [f(l[0], r[0], m[0])], [_t(x).long()])[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# connected components
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("density", [0.3, 0.6])
def test_sweep_cc_matches_scipy_label_and_jax(density):
    from scipy import ndimage

    mask = np.random.RandomState(1).rand(12, 20, 20) < density
    stats = {}
    lab, conv = P.sweep_cc_impl(_t(mask), stats=stats)
    assert conv and stats["rounds"] >= 1
    lab = lab.numpy()
    assert lab.dtype == np.int32
    jlab, jconv = J.sweep_cc_impl(jnp.asarray(mask))
    np.testing.assert_array_equal(lab, np.asarray(jlab))
    assert bool(jconv)
    ref, n_ref = ndimage.label(
        mask, structure=ndimage.generate_binary_structure(3, 1))
    assert (lab > 0).sum() == mask.sum()
    assert len(np.unique(lab[lab > 0])) == n_ref
    pairs = {(a, b) for a, b in zip(ref[mask].ravel(), lab[mask].ravel())}
    assert len(pairs) == n_ref


def test_sweep_cc_empty_mask():
    lab, conv = P.sweep_cc_impl(torch.zeros((4, 5, 6), dtype=torch.bool))
    assert conv and not lab.any()


def test_sweep_cc_round_cap_reports_not_converged():
    """A snake needs many rounds: one round leaves it unconverged, as the
    JAX function reports with the same cap."""
    mask = np.zeros((1, 9, 9), bool)
    mask[0, ::2, :] = True
    mask[0, 1::4, -1] = True
    mask[0, 3::4, 0] = True
    lab, conv = P.sweep_cc_impl(_t(mask), max_rounds=1)
    jlab, jconv = J.sweep_cc_impl(jnp.asarray(mask), max_rounds=1)
    assert conv == bool(jconv) is False
    np.testing.assert_array_equal(lab.numpy(), np.asarray(jlab))


# ---------------------------------------------------------------------------
# watershed
# ---------------------------------------------------------------------------

def test_two_basins_split_at_ridge():
    h = np.zeros((3, 9, 21), np.uint8)
    for x in range(21):
        h[:, :, x] = min(abs(x - 3), abs(x - 17)) * 12
    seeds = np.zeros_like(h, np.int32)
    seeds[1, 4, 3] = 1
    seeds[1, 4, 17] = 2
    lab, conv = P.sweep_watershed_impl(_t(h), _t(seeds), None)
    assert conv
    lab = lab.numpy()
    assert (lab[:, :, :10] == 1).all()
    assert (lab[:, :, 11:] == 2).all()


def test_full_coverage_seed_preservation_and_jax_labels(inst, jax_ws):
    _, hq, seeds, _ = inst
    stats = {}
    lab, conv = P.sweep_watershed_impl(_t(hq), _t(seeds), None,
                                       max_rounds=64, stats=stats)
    assert conv and 1 <= stats["rounds"] < 64
    lab = lab.numpy()
    assert lab.dtype == np.int32
    np.testing.assert_array_equal(lab, jax_ws["plain"][0])
    assert jax_ws["plain"][1]
    assert (lab > 0).all()
    sm = seeds > 0
    assert (lab[sm] == seeds[sm]).all()
    assert set(np.unique(lab)) <= set(np.unique(seeds))


def test_interior_agreement_with_flood(inst):
    from cluster_tools_tpu_torch import native

    _, hq, seeds, fg = inst
    lab = P.sweep_watershed_impl(_t(hq), _t(seeds), None,
                                 max_rounds=64)[0].numpy()
    flood = native.seeded_watershed_u8(hq, seeds.astype("int64"))
    agree = (lab[fg] == flood[fg]).mean()
    assert agree > 0.97, f"interior agreement {agree:.3f}"


def test_mask_blocks_transit():
    h = np.zeros((1, 5, 11), np.uint8)
    mask = np.ones_like(h, bool)
    mask[:, :, 5] = False
    seeds = np.zeros_like(h, np.int32)
    seeds[0, 2, 1] = 3
    lab, conv = P.sweep_watershed_impl(_t(h), _t(seeds), _t(mask))
    assert conv
    lab = lab.numpy()
    assert (lab[:, :, :5] == 3).all()
    assert not lab[:, :, 5:].any()


def test_random_mask_matches_jax(inst, jax_ws):
    _, hq, seeds, _ = inst
    mask = jax_ws["mask"]
    lab, conv = P.sweep_watershed_impl(_t(hq), _t(seeds), _t(mask),
                                       max_rounds=64)
    assert conv == jax_ws["masked"][1]
    np.testing.assert_array_equal(lab.numpy(), jax_ws["masked"][0])
    assert not lab.numpy()[~mask].any()


def test_min_size_filter_matches_jax(inst, jax_ws):
    _, hq, seeds, _ = inst
    stats = {}
    lab, conv = P.sweep_watershed_impl(
        _t(hq), _t(seeds), None, max_rounds=64, min_size=100,
        k_cap=int(seeds.max()) + 1, stats=stats)
    assert conv and "rounds_refill" in stats
    lab = lab.numpy()
    np.testing.assert_array_equal(lab, jax_ws["min_size"][0])
    assert (lab > 0).all()
    sizes = np.bincount(lab.ravel())
    assert (sizes[sizes > 0] >= 100).all()


def test_min_size_needs_k_cap():
    with pytest.raises(ValueError, match="k_cap"):
        P.sweep_watershed_impl(torch.zeros((2, 2, 2), dtype=torch.uint8),
                               torch.zeros((2, 2, 2), dtype=torch.int32),
                               None, min_size=5)


def test_wrapper_restores_ids():
    h = np.zeros((1, 4, 10), np.float32)
    h[0, :, 5] = 1.0
    seeds = np.zeros_like(h, np.int32)
    seeds[0, 1, 1] = 17
    seeds[0, 1, 8] = 99
    lab = P.sweep_watershed(_t(h), _t(seeds))
    assert lab.device.type == "cpu" and lab.dtype == torch.int32
    assert set(np.unique(lab.numpy())) == {17, 99}


def test_wrapper_float_heights_offset_ids_and_min_size_match_jax(inst):
    """Float heights quantized to 256 levels, globally offset seed ids,
    the size filter: the JAX wrapper's labels."""
    bnd, _, seeds, _ = inst
    ids = np.where(seeds > 0, seeds * 1000 + 7, 0).astype("int32")
    lab = P.sweep_watershed(_t(bnd), _t(ids), min_size=50)
    np.testing.assert_array_equal(
        lab.numpy(), np.asarray(J.sweep_watershed(bnd, ids, min_size=50)))


def test_wrapper_runs_on_the_heights_device():
    """The labels lie where the heights lie (with a CPU mask and seeds);
    only face connectivity is taken."""
    h = torch.zeros((2, 3, 4))
    lab = P.sweep_watershed(h, torch.ones((2, 3, 4), dtype=torch.int32),
                            mask=torch.ones((2, 3, 4), dtype=torch.bool))
    assert lab.device == h.device and (lab.numpy() == 1).all()
    with pytest.raises(ValueError, match="connectivity"):
        P.sweep_watershed(h, torch.ones((2, 3, 4), dtype=torch.int32),
                          connectivity=3)


# ---------------------------------------------------------------------------
# run-length coding and id compaction
# ---------------------------------------------------------------------------

def test_rle_roundtrip_matches_jax():
    rng = np.random.RandomState(0)
    x = np.repeat(rng.randint(0, 50, 200).astype("int32"),
                  rng.randint(1, 30, 200))
    starts, vals, n, ok = P.rle_encode(_t(x), 1024)
    assert ok and isinstance(n, int)
    dec = P.rle_decode(starts.numpy()[:n], vals.numpy()[:n], len(x))
    np.testing.assert_array_equal(dec, x)
    js, jv, jn, jok = J.rle_encode(jnp.asarray(x), 1024)
    assert n == int(jn) and ok == bool(jok)
    np.testing.assert_array_equal(starts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    # an empty input: no runs, not an overflow, zeroed buffers (the
    # count the JAX function means, ``jnp.where(n > 0, ..., 0)``; its
    # scatter itself raises on an empty input, ROADMAP section C)
    starts, vals, n, ok = P.rle_encode(_t(np.zeros(0, np.int32)), 8)
    assert (n, ok) == (0, True)
    assert starts.shape == vals.shape == (8,)
    assert not starts.any() and not vals.any()
    assert P.rle_decode(starts.numpy()[:n], vals.numpy()[:n], 0).size == 0


def test_rle_overflow_flag_matches_jax():
    x = np.arange(100, dtype=np.int32)  # 100 runs of length 1
    starts, vals, n, ok = P.rle_encode(_t(x), 10)
    assert not ok and n == 100
    js, jv, jn, jok = J.rle_encode(jnp.asarray(x), 10)
    assert not bool(jok) and int(jn) == n
    np.testing.assert_array_equal(starts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_compact_ids():
    lab = np.array([[0, 5, 5], [9, 0, 5]], np.int32)
    dense, k = P.compact_ids(_t(lab), 16)
    assert int(k) == 2
    np.testing.assert_array_equal(dense.numpy(), [[0, 1, 1], [2, 0, 1]])


@pytest.mark.parametrize("cap", [8, 30, 64])
def test_compact_ids_matches_jax_past_the_cap(cap):
    """Ids at and past ``cap`` and negative ids: the JAX scatter wraps and
    drops them, the port masks them first; the ranks agree."""
    lab = np.random.RandomState(cap).randint(-3, 40, (5, 6, 7)).astype(
        "int32")
    dense, k = P.compact_ids(_t(lab), cap)
    jd, jk = J.compact_ids(jnp.asarray(lab), cap)
    assert dense.dtype == torch.int32 and int(k) == int(jk)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jd))


def test_packed_rle_roundtrip_and_flags():
    """tests/test_sweep.py's TestPackedRLE on the port's encoder (held to
    the JAX encoder word for word in tests/test_torch_ops.py)."""
    rng = np.random.RandomState(0)
    x = np.repeat(rng.randint(0, 500, 300).astype("int32"),
                  rng.randint(1, 60000, 300))
    packed, n, ok = P.rle_encode_packed(_t(x), 1 << 16)
    assert ok
    dec = P.rle_decode_packed(packed.numpy(), n, len(x))
    np.testing.assert_array_equal(dec, x.astype("uint16"))
    *_, ok = P.rle_encode_packed(_t(np.arange(100, dtype=np.int32)), 10)
    assert not ok
    *_, ok = P.rle_encode_packed(_t(np.full(10, 1 << 16, np.int32)), 64)
    assert not ok
