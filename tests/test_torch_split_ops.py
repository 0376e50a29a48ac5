"""The split chain's RAG primitives in the port (plain PyTorch on the CPU)
against the JAX package's on the same seeded numpy inputs: label
densification, label pairs, affinity samples and the submit/finalize edge
statistics with the compaction forced on and off.  Integers are compared
exactly; so are the float statistics, where the port sums the segments in
the order XLA's CPU scatter-add does."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cluster_tools_tpu.ops import rag as jr
from cluster_tools_tpu_torch.ops import rag as pr

torch.set_num_threads(2)


def _labels(shape, n_labels, seed, zero_frac=0.1, big=False):
    """Piecewise-constant labels (blocky regions, a share of background),
    optionally with uint64 ids beyond 2^32."""
    rng = np.random.RandomState(seed)
    coarse = rng.randint(1, n_labels + 1, [-(-s // 3) for s in shape])
    lab = np.kron(coarse, np.ones((3, 3, 3), "int64"))[
        tuple(slice(0, s) for s in shape)].astype("uint64")
    lab[rng.rand(*shape) < zero_frac] = 0
    if big:
        lab[lab > 0] += np.uint64(7 << 33)
    return lab


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("big,zero_frac", [(False, 0.1), (True, 0.1),
                                           (False, 0.0)])
def test_densify_labels_exact(big, zero_frac):
    lab = _labels((9, 14, 11), 30, seed=1, zero_frac=zero_frac, big=big)
    lut_p, dense_p = pr.densify_labels(lab)
    lut_j, dense_j = jr.densify_labels(lab)
    np.testing.assert_array_equal(lut_p, lut_j)
    np.testing.assert_array_equal(dense_p, dense_j)
    assert dense_p.dtype == np.int32 and lut_p[0] == 0
    np.testing.assert_array_equal(lut_p[dense_p], lab)


@pytest.mark.parametrize("ignore_label", [True, False])
@pytest.mark.parametrize("inner", [None, (8, 13, 10), (5, 13, 4)])
def test_label_pairs_exact(ignore_label, inner):
    lab = _labels((9, 14, 11), 25, seed=2)
    _, dense = pr.densify_labels(lab)
    up, vp, okp = pr.label_pairs(_t(dense), ignore_label=ignore_label,
                                 inner_shape=inner)
    uj, vj, okj = jr.label_pairs(jnp.asarray(dense),
                                 ignore_label=ignore_label,
                                 inner_shape=inner)
    np.testing.assert_array_equal(okp.numpy(), np.asarray(okj))
    np.testing.assert_array_equal(up.numpy(), np.asarray(uj))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(vj))
    # and the host analog's deduplicated table equals the device dedup
    host = pr.host_label_pairs(dense, ignore_label, inner)
    np.testing.assert_array_equal(
        host, jr.host_label_pairs(dense, ignore_label, inner))
    np.testing.assert_array_equal(
        pr.device_unique_edges(up, vp, okp), host.astype("int64"))


@pytest.mark.parametrize("offsets,begin,inner", [
    ([[-1, 0, 0], [0, -1, 0], [0, 0, -1]], None, None),
    ([[-1, 0, 0], [0, -3, 0], [0, 0, 4], [2, 2, 0]], (2, 3, 4), (5, 6, 4)),
])
def test_affinity_pair_values_exact(offsets, begin, inner):
    lab = _labels((10, 13, 12), 20, seed=3)
    _, dense = pr.densify_labels(lab)
    affs = np.random.RandomState(4).rand(len(offsets), *lab.shape).astype(
        "float32")
    outp = pr.affinity_pair_values(_t(dense), _t(affs), offsets,
                                   inner_begin=begin, inner_shape=inner)
    outj = jr.affinity_pair_values(jnp.asarray(dense), jnp.asarray(affs),
                                   offsets, inner_begin=begin,
                                   inner_shape=inner)
    for p, j in zip(outp, outj):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))


def _boundary_samples(shape, seed):
    lab = _labels(shape, 40, seed=seed)
    _, dense = pr.densify_labels(lab)
    rng = np.random.RandomState(seed + 10)
    bmap = np.round(rng.rand(*shape) * 255).astype("float32") / 255.0
    inner = tuple(s - 1 for s in shape)
    return dense, bmap, inner


@pytest.mark.parametrize("compact", [False, True])
@pytest.mark.parametrize("shape", [(9, 14, 11), (12, 20, 17)])
def test_edge_stats_submit_finalize_exact(compact, shape):
    """Submit + finalize on boundary samples (two per face, float
    values): the (u, v) table and every feature column equal the JAX
    package's, with the compaction forced on and off."""
    dense, bmap, inner = _boundary_samples(shape, seed=5)
    u, v, val, ok = pr.boundary_pair_values(_t(dense), _t(bmap),
                                            inner_shape=inner)
    uvp, fp = pr.device_edge_stats_finalize(
        pr.device_edge_stats_submit(u, v, val, ok, e_max=4096,
                                    compact=compact), 4096)
    uj, vj, valj, okj = jr.boundary_pair_values(
        jnp.asarray(dense), jnp.asarray(bmap), inner_shape=inner)
    uvj, fj = jr.device_edge_stats_finalize(
        jr.device_edge_stats_submit(uj, vj, valj, okj, e_max=4096,
                                    compact=compact), 4096)
    assert len(uvp) > 50
    np.testing.assert_array_equal(uvp, uvj)
    np.testing.assert_array_equal(fp, fj)


def test_edge_stats_overflows_raise_like_the_jax_package():
    """The edge capacity and the compaction capacity overflow in the same
    cases and raise."""
    dense, bmap, inner = _boundary_samples((9, 14, 11), seed=6)
    u, v, val, ok = pr.boundary_pair_values(_t(dense), _t(bmap),
                                            inner_shape=inner)
    with pytest.raises(RuntimeError, match="e_max=8"):
        pr.device_edge_stats_finalize(
            pr.device_edge_stats_submit(u, v, val, ok, e_max=8), 8)
    # every sample valid: more than a quarter of the padded length
    n = 1 << 20
    ones = torch.ones(n, dtype=torch.bool)
    ids = torch.arange(n, dtype=torch.int32) % 7
    handles = pr.device_edge_stats_submit(ids, ids + 1,
                                          torch.zeros(n), ones, e_max=16)
    assert handles[0] == "compact" and handles[3] == n // 4
    with pytest.raises(RuntimeError, match="compaction capacity"):
        pr.device_edge_stats_finalize(handles, 16)
