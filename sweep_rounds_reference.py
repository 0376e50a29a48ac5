"""Rounds the JAX package's sweep watershed needs on the main path's
first outer block, on the CPU.

Run from the root of a checkout:

    JAX_PLATFORMS=cpu python3 sweep_rounds_reference.py [--shape Z Y X]

It rebuilds the first outer block ``(58, 576, 576)`` (the default
``--shape``) of the benchmark volume (``bench.synthetic_instance`` of
``(125, 1250, 1250)``, seed 0, stored as uint8) by querying the same
Voronoi points at that crop only, makes heights and seeds by
``tests/test_sweep.py``'s recipe, and runs
``cluster_tools_tpu.ops.sweep.sweep_watershed_impl`` with round caps of
24 (its default), 25 and 26, printing whether each converged.  The
block's seed count and foreground share are printed too, to be held to
what ``chip_smoke.py`` phase 15b logs for the same block, and the
peak host memory at the end.
"""

import argparse
import json
import resource
import time

import numpy as np

import bench


def bench_block(shape, full=bench.SHAPE, seed=0):
    """``bench.synthetic_instance(full, seed)``'s boundary map at
    ``[0:shape]``, as uint8: the same points, queried at the crop only."""
    from scipy.spatial import cKDTree

    n_cells = max(int(np.prod(full) / bench.CELL_DENSITY), 8)
    rng = np.random.RandomState(seed)
    pts = (rng.rand(n_cells, 3) * np.array(full)).astype("float32")
    grid = np.meshgrid(*(np.arange(n, dtype="float32") for n in shape),
                       indexing="ij")
    q = np.stack([g.ravel() for g in grid], axis=1)
    d, _ = cKDTree(pts).query(q, k=2, workers=-1)
    bnd = np.exp(-0.5 * ((d[:, 1] - d[:, 0]) / 2.0) ** 2).reshape(
        shape).astype("float32")
    return np.round(bnd * 255).astype("uint8")


def main():
    import jax.numpy as jnp

    from cluster_tools_tpu.ops.sweep import sweep_watershed_impl
    from tests.test_sweep import _height_and_seeds

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", type=int, nargs=3, default=(58, 576, 576))
    args = ap.parse_args()
    shape = tuple(args.shape)
    t0 = time.perf_counter()
    raw = bench_block(shape)
    hq, seeds, fg = _height_and_seeds(raw.astype("float32") / 255.0)
    print(f"block {list(shape)} seeds {int(seeds.max())} foreground "
          f"{float(fg.mean())} setup_s {time.perf_counter() - t0}",
          flush=True)
    res = {}
    for cap in (24, 25, 26):
        t0 = time.perf_counter()
        _, conv = sweep_watershed_impl(jnp.asarray(hq), jnp.asarray(seeds),
                                       None, max_rounds=cap)
        res[cap] = bool(conv)
        print(f"max_rounds {cap} converged {res[cap]} "
              f"wall_s {time.perf_counter() - t0}", flush=True)
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(json.dumps({"shape": list(shape), "converged": res,
                      "peak_rss_gb": peak}))


if __name__ == "__main__":
    main()
