"""The port's device mesh and halo ring (``parallel/mesh.py``,
``parallel/stencil.py``) and the device-op helpers of the mesh programs,
against the JAX package on the CPU.  The JAX side runs on the 8 virtual
CPU devices ``tests/conftest.py`` forces; the port's side runs its shards
on the CPU (``"mesh_devices"`` places several shards on one device).
Exact: shapes, values, shard layouts."""

import numpy as np
import pytest
import torch

from cluster_tools_tpu_torch.parallel import mesh as pmesh
from cluster_tools_tpu_torch.parallel import stencil as pstencil

CPU = torch.device("cpu")


def _devs(n):
    return pmesh.shard_devices("cpu", n)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12])
def test_factorize_matches_jax(n):
    from cluster_tools_tpu.parallel.mesh import _factorize

    assert pmesh._factorize(n) == _factorize(n)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_mesh_shapes_match_jax(n):
    """``make_mesh``, ``blocks_mesh`` and ``single_axis_mesh`` have the
    JAX package's axis names and sizes; ``n`` shards on the one CPU count
    one physical device."""
    import jax

    from cluster_tools_tpu.parallel import mesh as jmesh

    got = pmesh.make_mesh(devices=_devs(n))
    want = jmesh.make_mesh(n)
    assert got.axis_names == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert got.size == n and got.physical_devices == 1
    assert got.describe()["mesh_devices"] == n
    b = pmesh.blocks_mesh(devices=_devs(n))
    assert b.shape == dict(jmesh.blocks_mesh(n).shape)
    s = pmesh.single_axis_mesh("shard", n, devices=_devs(n))
    assert s.shape == dict(jmesh.single_axis_mesh("shard", n).shape)
    assert len(jax.devices()) >= n
    with pytest.raises(ValueError, match="need"):
        pmesh.single_axis_mesh("shard", n + 1, devices=_devs(n))


def test_shard_devices_round_robin_and_no_card():
    assert pmesh.shard_devices("cpu") == [CPU]
    assert pmesh.shard_devices("cpu", 3) == [CPU] * 3
    assert pmesh.config_devices({"device": "cpu", "mesh_devices": 8}) == \
        [CPU] * 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.shard_devices("cuda", 4)


def test_shard_unshard_round_trip_and_placements():
    """``shard`` cuts the JAX package's pieces for a volume placement
    (z over ``space``, batch over ``data``), every piece a real copy, and
    ``unshard`` joins them back; ``param_sharding`` splits the last dim
    over ``model`` where it divides, as the JAX package does."""
    mesh = pmesh.make_mesh(devices=_devs(8))        # (2, 2, 2)
    x = torch.arange(2 * 8 * 3 * 5 * 1, dtype=torch.float32).reshape(
        2, 8, 3, 5, 1)
    pl = pmesh.volume_sharding(mesh, ndim=3, batch=True)
    assert pl.spec == ("data", "space", None, None, None)
    shards = pmesh.shard(x, mesh, pl)
    assert len(shards) == 8
    assert [tuple(s.shape) for s in shards] == [(1, 4, 3, 5, 1)] * 8
    # the model axis replicates: positions 0 and 1 hold the same piece
    assert torch.equal(shards[0], shards[1])
    assert shards[0].data_ptr() != shards[1].data_ptr()
    assert torch.equal(shards[0], x[:1, :4])
    assert torch.equal(shards[2], x[:1, 4:])
    assert torch.equal(shards[4], x[1:, :4])
    assert torch.equal(pmesh.unshard(shards, mesh, pl), x)
    rep = pmesh.shard(x, mesh, pmesh.replicated(mesh))
    assert all(torch.equal(r, x) for r in rep)

    import jax

    from cluster_tools_tpu.parallel import mesh as jmesh

    params = {"k": np.zeros((3, 3, 4), "float32"),
              "b": np.zeros((4,), "float32"),
              "odd": np.zeros((2, 3), "float32")}
    want = jmesh.param_sharding(jmesh.make_mesh(8), params)
    got = pmesh.param_sharding(mesh, {k: torch.from_numpy(v)
                                      for k, v in params.items()})
    for k in params:
        spec = tuple(want[k].spec)
        assert got[k].spec == spec, (k, got[k].spec, spec)
    assert len(jax.devices()) >= 8


def _jax_exchange(x, halo, axis, n_shards, mode, fill):
    from test_stencil import _run_exchange

    return _run_exchange(x, halo, axis, n_shards, mode=mode, fill=fill)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("mode", ["constant", "reflect"])
@pytest.mark.parametrize("axis", [0, 1])
def test_halo_exchange_matches_jax(n_shards, mode, axis):
    rng = np.random.RandomState(n_shards)
    shape = [5, 6, 4]
    shape[axis] = 6 * n_shards
    x = rng.rand(*shape).astype("float32")
    halo = 2
    want = _jax_exchange(x, halo, axis, n_shards, mode, -1.0)
    shards = [torch.from_numpy(s.copy())
              for s in np.split(x, n_shards, axis=axis)]
    got = pstencil.halo_exchange(shards, halo, axis, fill=-1.0, mode=mode)
    assert len(got) == n_shards
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # crop_halo gives the shards back, shard by shard and on a list
    for g, s in zip(pstencil.crop_halo(got, halo, axis), shards):
        assert torch.equal(g, s)


def test_halo_exchange_takes_copies():
    """Shards on one device never alias: writing into a grown shard's
    halo leaves the neighbour's data alone."""
    shards = [torch.zeros(4, 3), torch.ones(4, 3)]
    grown = pstencil.halo_exchange(shards, 1, 0)
    grown[0][-1] = 7.0
    grown[1][0] = 9.0
    assert torch.equal(shards[1], torch.ones(4, 3))
    assert torch.equal(shards[0], torch.zeros(4, 3))
    with pytest.raises(ValueError, match="reflect halo"):
        pstencil.halo_exchange([torch.zeros(2, 3)] * 2, 2, 0,
                               mode="reflect")


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("mode", ["constant", "reflect"])
def test_sharded_stencil_matches_jax(n_shards, mode):
    """A 3-point Gaussian along z through ``sharded_stencil`` equals the
    JAX package's ``sharded_stencil`` of the same stencil, bit for bit,
    and the dense stencil away from the volume ends."""
    import jax.numpy as jnp

    from cluster_tools_tpu.parallel.mesh import single_axis_mesh
    from cluster_tools_tpu.parallel.stencil import sharded_stencil

    rng = np.random.RandomState(2)
    x = rng.rand(4 * n_shards, 5, 6).astype("float32")
    w = np.array([0.25, 0.5, 0.25], "float32")

    def jfn(a):
        return w[0] * a[:-2] + w[1] * a[1:-1] + w[2] * a[2:]

    def jpad(a):  # the stencil keeps the shape: the ends pass through
        return jnp.concatenate([a[:1], jfn(a), a[-1:]], axis=0)

    def tfn(a):
        return torch.cat([a[:1], float(w[0]) * a[:-2] + float(w[1]) * a[1:-1]
                          + float(w[2]) * a[2:], a[-1:]], dim=0)

    jm = single_axis_mesh("space", n_shards)
    want = np.asarray(sharded_stencil(jpad, jm, halo=1, axis=0,
                                      mesh_axis="space", mode=mode)(
        jnp.asarray(x)))
    tm = pmesh.single_axis_mesh("space", n_shards, devices=_devs(n_shards))
    f = pstencil.sharded_stencil(tfn, tm, halo=1, axis=0,
                                 mesh_axis="space", mode=mode)
    got = f(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    dense = tfn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.numpy()[1:-1], dense[1:-1])
    # the list form returns the shards
    parts = f(pmesh.shard(torch.from_numpy(x), tm,
                          pmesh.Placement(("space",))))
    np.testing.assert_array_equal(torch.cat(parts).numpy(), want)


def test_sharded_stencil_on_a_multi_axis_mesh():
    """On the (2, 2, 2) mesh the rings run along ``space`` only; the
    positions that differ on ``data``/``model`` hold the same results."""
    mesh = pmesh.make_mesh(devices=_devs(8))
    x = torch.from_numpy(np.random.RandomState(5).rand(8, 4, 4)
                         .astype("float32"))

    def box(a):
        return torch.cat([a[:1], (a[:-2] + a[1:-1] + a[2:]) / 3.0, a[-1:]])

    got = pstencil.sharded_stencil(box, mesh, 1, mode="reflect")(x)
    xp = torch.cat([x[1:2], x, x[-2:-1]])
    np.testing.assert_array_equal(got.numpy(), box(xp)[1:-1].numpy())


def test_plane_face_pairs_matches_jax():
    import jax.numpy as jnp

    from cluster_tools_tpu.ops.rag import plane_face_pairs as jpfp
    from cluster_tools_tpu_torch.ops.rag import plane_face_pairs

    rng = np.random.RandomState(3)
    a = rng.randint(0, 5, (7, 9)).astype("int32")
    b = rng.randint(0, 5, (7, 9)).astype("int32")
    valid = rng.rand(7, 9) > 0.3
    for v in (None, valid):
        for ign in (True, False):
            want = jpfp(jnp.asarray(a), jnp.asarray(b),
                        valid=None if v is None else jnp.asarray(v),
                        ignore_label=ign)
            got = plane_face_pairs(
                torch.from_numpy(a), torch.from_numpy(b),
                valid=None if v is None else torch.from_numpy(v),
                ignore_label=ign)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("origin,vol_shape", [
    ([0, 0, 0], (6, 5, 4)), ([12, 0, 0], (14, 5, 4)),
    ([18, 0, 0], (14, 5, 4)), ([3, 2, 1], (8, 6, 4))])
def test_extent_valid_mask_origin_matches_jax(origin, vol_shape):
    import jax.numpy as jnp

    from cluster_tools_tpu.ops.watershed import extent_valid_mask as jevm
    from cluster_tools_tpu_torch.ops.watershed import extent_valid_mask

    local = (6, 5, 4)
    want = np.asarray(jevm(local, origin=jnp.asarray(origin),
                           vol_shape=vol_shape))
    got = extent_valid_mask(local, origin=origin, vol_shape=vol_shape)
    np.testing.assert_array_equal(got.numpy(), want)
    # the extent convention still holds
    np.testing.assert_array_equal(
        extent_valid_mask(local, [4, 5, 2]).numpy(),
        np.asarray(jevm(local, extent=jnp.asarray([4, 5, 2]))))
    with pytest.raises(ValueError):
        extent_valid_mask(local)


@pytest.mark.parametrize("impl", ["host", "device"])
def test_grid_graph_edges_id_offset_matches_jax(impl):
    from cluster_tools_tpu.ops.mws import grid_graph_edges as jgge
    from cluster_tools_tpu_torch.ops.mws import grid_graph_edges

    rng = np.random.RandomState(0)
    affs = rng.rand(3, 4, 5, 6).astype("float32")
    offsets = [[-1, 0, 0], [0, -1, 0], [0, 0, -1]]
    want = jgge(affs, offsets, impl="host", id_offset=1000)
    got = grid_graph_edges(affs, offsets, impl=impl, id_offset=1000,
                           device="cpu")
    if impl == "host":
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        order_g = np.lexsort(got[0].T[::-1])
        order_w = np.lexsort(want[0].T[::-1])
        np.testing.assert_array_equal(got[0][order_g], want[0][order_w])
        np.testing.assert_array_equal(got[1][order_g], want[1][order_w])
    base = grid_graph_edges(affs, offsets, impl=impl, device="cpu")
    np.testing.assert_array_equal(np.sort(got[0], axis=0),
                                  np.sort(base[0] + 1000, axis=0))


def test_edge_stats_hist_dual_matches_jax():
    """The dual-sample histogram statistics with unrestricted (global)
    ids, exactly as the JAX package computes them."""
    import jax.numpy as jnp

    from cluster_tools_tpu.ops.rag import _edge_stats_hist_dual
    from cluster_tools_tpu_torch.ops.rag import edge_stats_hist_dual

    rng = np.random.RandomState(4)
    n = 500
    u = rng.randint(1, 40000, n).astype("int32")
    v = (u + rng.randint(1, 5, n)).astype("int32")
    a = rng.randint(0, 256, n).astype("int32")
    b = rng.randint(0, 256, n).astype("int32")
    ok = rng.rand(n) > 0.2
    for e_max in (64, 1024):
        want = _edge_stats_hist_dual(jnp.asarray(u), jnp.asarray(v),
                                     jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(ok), e_max=e_max)
        got = edge_stats_hist_dual(torch.from_numpy(u), torch.from_numpy(v),
                                   torch.from_numpy(a), torch.from_numpy(b),
                                   torch.from_numpy(ok), e_max)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert int(got[2]) == int(want[2]) and int(got[3]) == int(want[3])
