"""The yardstick's arithmetic and plain references, on the CPU."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from portbench import run
from portbench.refs import cost, fragments, gaec, multicut, n5, volume
from portbench.refs import unet as R


def _unet():
    """(configuration, its (features, scales), the port's module at them
    in float32)."""
    from cluster_tools_tpu_torch.models.unet import create_unet

    _, cfg = run.load_cell("unet-train.crops")
    arch = run.load_driver("unet_train").architecture(cfg)
    model = create_unet(out_channels=cfg["out_channels"], features=arch[0],
                        anisotropic=arch[1][0] == (1, 2, 2),
                        dtype=torch.float32)
    return cfg, arch, model


@pytest.mark.parametrize("which", ["configuration", "port_default"])
def test_unet_flop_equals_the_module_convolutions(which):
    """The frozen count equals torch's count of the port's own module's
    convolutions (2 x multiply-adds, up-convolutions included), at the
    configuration's widths and at the port's default ones."""
    from torch.utils.flop_counter import FlopCounterMode

    from cluster_tools_tpu_torch.models.unet import create_unet

    if which == "configuration":
        _, arch, model = _unet()
    else:
        model = create_unet(dtype=torch.float32)
        arch = (model.features, model.scale_factors)
    shape = (8, 32, 32)
    with FlopCounterMode(display=False) as fc:
        model(torch.zeros((2, 1) + shape))
    assert fc.get_total_flops() == 2 * cost.unet_forward_flop(shape, *arch)
    assert cost.unet_step_flop(8, (32, 256, 256), *arch) == \
        3 * 8 * cost.unet_forward_flop((32, 256, 256), *arch)


def test_minplus_bytes_follow_the_block_shape():
    outer = [50 + 2 * 4, 512 + 2 * 32, 512 + 2 * 32]
    assert outer == [58, 576, 576]
    assert cost.edt_bytes(outer) == 8 * 58 * 576 * 576 * 3
    # 27 blocks at 3.35 TB/s
    assert 27 * cost.edt_bytes(outer) / cost.PEAK_HBM_BYTES == \
        pytest.approx(27 * 0.13785e-3, rel=1e-3)


def test_reference_unet_has_the_port_s_parameters():
    cfg, arch, model = _unet()
    sd = model.state_dict()
    shapes = R.param_shapes(*arch, cfg["in_channels"], cfg["out_channels"])
    assert list(shapes) == list(sd)
    assert all(tuple(sd[k].shape) == s for k, s in shapes.items())
    assert sum(math.prod(s) for s in shapes.values()) == cfg["n_params"]


def test_reference_unet_forward_matches_the_port_in_float32():
    _, arch, model = _unet()
    torch.manual_seed(0)
    p = {k: torch.randn_like(v) * 0.1 for k, v in model.state_dict().items()}
    x = torch.randn(1, 1, 8, 32, 32)
    got = torch.func.functional_call(model, p, (x,))
    torch.testing.assert_close(R.forward(p, x, arch[1]), got, rtol=1e-5,
                               atol=1e-6)


def test_volume_two_nearest_is_exact():
    shape = (20, 40, 50)
    lab, bnd = volume.synthetic_volume(shape, 7, "cpu")
    pts = volume.cell_centres(shape, 7, "cpu")
    zz, yy, xx = torch.meshgrid(*[torch.arange(s, dtype=torch.float32)
                                  for s in shape], indexing="ij")
    q = torch.stack([zz, yy, xx], -1).reshape(-1, 3)
    d = ((q[:, None] - pts[None]) ** 2).sum(-1)
    v, i = torch.topk(d, 2, largest=False)
    assert torch.equal(lab.reshape(-1), (i[:, 0] + 1).int())
    b = torch.exp(-0.5 * ((v[:, 1].sqrt() - v[:, 0].sqrt()) / 2) ** 2)
    assert torch.equal(bnd.reshape(-1), torch.round(b * 255).to(torch.uint8))
    lab2, bnd2 = volume.synthetic_volume(shape, 7, "cpu")
    assert torch.equal(bnd, bnd2) and torch.equal(lab, lab2)
    assert not torch.equal(bnd, volume.synthetic_volume(shape, 8, "cpu")[1])


def test_n5_round_trip_and_the_port_reads_it(tmp_path):
    from cluster_tools_tpu_torch.core.storage import file_reader

    a = np.random.default_rng(0).integers(0, 2 ** 40, (13, 20, 17),
                                          dtype=np.uint64)
    n5.write_array(str(tmp_path / "x.n5"), "a", a, [5, 8, 8])
    assert np.array_equal(n5.read_array(str(tmp_path / "x.n5"), "a"), a)
    with file_reader(str(tmp_path / "x.n5"), "r") as f:
        assert np.array_equal(f["a"][:], a)
    with file_reader(str(tmp_path / "y.n5")) as f:
        ds = f.require_dataset("b", shape=a.shape, chunks=[4, 7, 9],
                               dtype="uint64", compression="gzip")
        ds[:] = a
    assert np.array_equal(n5.read_array(str(tmp_path / "y.n5"), "b"), a)


def test_pair_excess_is_zero_for_one_partition_only():
    a = torch.tensor([1, 1, 2, 2, 3])
    assert fragments.pair_excess(a, a * 7 + 1) == 0
    assert fragments.pair_excess(a, torch.tensor([1, 1, 2, 3, 3])) > 0
    assert fragments.pair_excess(a, torch.tensor([1, 1, 1, 1, 3])) > 0


def test_reference_features_by_hand():
    ws = torch.zeros((1, 1, 4), dtype=torch.int64)
    ws[0, 0] = torch.tensor([1, 2, 2, 3])
    bmap = torch.tensor([[[0, 255, 51, 102]]], dtype=torch.uint8)
    uv, hist = multicut.rag_histograms(ws, bmap)
    assert uv.tolist() == [[1, 2], [2, 3]]
    f = multicut.features(hist)
    # edge (1, 2): samples 0 and 1 -> mean 0.5, count 2
    assert f[0, 0].item() == pytest.approx(0.5)
    assert f[0, 9].item() == 2
    assert f[1, 0].item() == pytest.approx((0.2 + 0.4) / 2)
    c = multicut.costs(f[:, 0])
    p = 0.998 * 0.5 + 0.001
    assert c[0].item() == pytest.approx(math.log((1 - p) / p))


def test_merge_gain_and_gaec():
    uv = torch.tensor([[0, 1], [1, 2], [0, 2]])
    cost = torch.tensor([2.0, -1.0, -1.0], dtype=torch.float64)
    # 0 and 1 apart: merging them gains 2
    assert multicut.merge_gain(uv, cost, torch.tensor([0, 1, 2])) == 2.0
    assert multicut.merge_gain(uv, cost, torch.tensor([0, 0, 2])) == 0.0
    labels = gaec.gaec(3, uv.numpy(), cost.numpy())
    assert labels[0] == labels[1] != labels[2]


def test_node_moves_and_the_objective_gap():
    """On a graph where GAEC stops short, the node moves lower the
    objective; the objective gap shows GAEC's labelling and every node in
    one segment, where the merge gain reads 0 for both."""
    uv = torch.tensor([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]])
    cost = torch.tensor([3.0, -2.8, 0.4, 2.9, -2.4, -2.7],
                        dtype=torch.float64)
    g = gaec.gaec(4, uv.numpy(), cost.numpy())
    assert g.tolist() == [0, 0, 0, 1]
    r = gaec.solve(4, uv.numpy(), cost.numpy())
    assert r.tolist() == [1, 0, 0, 1]
    assert gaec.objective(uv.numpy(), cost.numpy(), g) == pytest.approx(-4.7)
    assert gaec.objective(uv.numpy(), cost.numpy(), r) == pytest.approx(-4.9)
    ref = multicut.solved_lut(uv, cost)
    assert multicut.objective_gap(uv, cost, ref) == 0.0
    gl = torch.from_numpy(g)
    assert multicut.merge_gain(uv, cost, gl) == 0.0
    assert multicut.objective_gap(uv, cost, gl) == pytest.approx(0.2 / 4.9)
    one = torch.zeros(4, dtype=torch.int64)
    assert multicut.merge_gain(uv, cost, one) == 0.0
    assert multicut.objective_gap(uv, cost, one) == pytest.approx(1.0)
