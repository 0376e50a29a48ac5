"""First-party native kernels (C++), loaded via ctypes.

Replaces the reference's external pybind11 wheels for combinatorial work
(nifty solvers/ufd — SURVEY §2.3) and the blosc library's codecs.  Two
shared libraries are compiled with g++ the first time a process needs
them (the C API is flat arrays; see ``core/build.py``): the solvers from
``src/solvers.cpp`` and the chunk formats' codecs (LZ4, BloscLZ,
Zstandard, Snappy, LZF, the byte shuffle and bitshuffle, HDF5's lookup3
and OCDBT's CRC-32C checksums; wrapped by ``core/codecs.py``) from
``src/codecs.cpp``.  Without a compiler they raise: the package has no slower stand-in for them.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from ..core.build import build_shared

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src",
                    "solvers.cpp")
_CODECS_SRC = os.path.join(os.path.dirname(_SRC), "codecs.cpp")
_CMD = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_codecs: Optional[ctypes.CDLL] = None


def library() -> str:
    """The solver library's path, built at first use (each call resolves
    through ``core/build.py``'s counted cache)."""
    # ctt-lint: disable=metric-registry (a library's file name, not a metric)
    return build_shared("ctt_torch_native", [_SRC], _CMD)


def load() -> ctypes.CDLL:
    """Build (at first use) and load the solver library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(library())
        i64 = ctypes.c_int64
        p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        p_u64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        lib.ufd_merge_pairs.argtypes = [i64, i64, p_i64, p_u64]
        lib.ufd_merge_pairs.restype = None
        lib.mc_gaec.argtypes = [i64, i64, p_i64, p_f64, p_u64]
        lib.mc_gaec.restype = i64
        lib.mc_kl_refine.argtypes = [i64, i64, p_i64, p_f64, p_u64, i64,
                                     ctypes.c_double]
        lib.mc_kl_refine.restype = i64
        p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.mws_clustering.argtypes = [i64, i64, p_i64, p_f64, i64, p_i64,
                                       p_f64, p_u64]
        lib.mws_clustering.restype = i64
        lib.mws_clustering_sorted.argtypes = [i64, i64, p_i32, p_i32, p_u8,
                                              p_u64]
        lib.mws_clustering_sorted.restype = i64
        lib.lmc_gaec.argtypes = [i64, i64, p_i64, p_f64, i64, p_i64, p_f64,
                                 p_u64]
        lib.lmc_gaec.restype = i64
        lib.lmc_kl_refine.argtypes = [i64, i64, p_i64, p_f64, i64, p_i64,
                                      p_f64, p_u64, i64, ctypes.c_double]
        lib.lmc_kl_refine.restype = i64
        lib.agglomerate_edge_weighted.argtypes = [
            i64, i64, p_i64, p_f64, p_f64, p_f64, ctypes.c_double,
            ctypes.c_double, p_u64]
        lib.agglomerate_edge_weighted.restype = i64
        lib.seeded_watershed_u8.argtypes = [p_u8, i64, i64, i64, p_i64]
        lib.seeded_watershed_u8.restype = None
        lib.size_filter_u8.argtypes = [p_u8, i64, i64, i64, p_i64, i64]
        lib.size_filter_u8.restype = None
        lib.graph_watershed.argtypes = [i64, i64, p_i64, p_f64, p_u64]
        lib.graph_watershed.restype = None
        lib.skeletonize_3d.argtypes = [p_u8, i64, i64, i64]
        lib.skeletonize_3d.restype = None
        _lib = lib
        return _lib


def codecs() -> ctypes.CDLL:
    """Build (at first use) and load the codec library.  Its functions
    take raw addresses (``ndarray.ctypes.data``) and byte counts; ctypes
    releases the GIL for each call."""
    global _codecs
    with _lock:
        if _codecs is not None:
            return _codecs
        # ctt-lint: disable=metric-registry (a library's file name, not a metric)
        lib = ctypes.CDLL(build_shared("ctt_torch_codecs", [_CODECS_SRC],
                                       _CMD))
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        for name in ("lz4_compress", "lz4_decompress", "blosclz_decompress",
                     "zstd_decompress", "snappy_decompress",
                     "lzf_decompress"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, i64, ptr, i64]
            fn.restype = i64
        lib.lz4_bound.argtypes = [i64]
        lib.lz4_bound.restype = i64
        for name in ("byte_shuffle", "byte_unshuffle"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, i64, i64, ptr]
            fn.restype = None
        lib.bitunshuffle.argtypes = [ptr, i64, i64, i64, ptr]
        lib.bitunshuffle.restype = None
        lib.lookup3.argtypes = [ptr, i64, ctypes.c_uint32]
        lib.lookup3.restype = ctypes.c_uint32
        lib.crc32c.argtypes = [ptr, i64, ctypes.c_uint32]
        lib.crc32c.restype = ctypes.c_uint32
        _codecs = lib
        return _codecs


def _as_uv(uv_ids: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(uv_ids, dtype=np.int64).reshape(-1, 2)


# ---------------------------------------------------------------------------
# union-find
# ---------------------------------------------------------------------------

def ufd_merge_pairs(n_nodes: int, pairs: np.ndarray) -> np.ndarray:
    """Root label per node after merging all pairs (boost_ufd equivalent)."""
    pairs = _as_uv(pairs)
    out = np.empty(n_nodes, dtype=np.uint64)
    load().ufd_merge_pairs(n_nodes, len(pairs), pairs, out)
    return out


# ---------------------------------------------------------------------------
# multicut
# ---------------------------------------------------------------------------

def multicut_gaec(n_nodes: int, uv_ids: np.ndarray,
                  costs: np.ndarray) -> np.ndarray:
    """Greedy additive edge contraction (nifty greedyAdditive equivalent)."""
    uv = _as_uv(uv_ids)
    costs = np.ascontiguousarray(costs, dtype=np.float64)
    out = np.empty(n_nodes, dtype=np.uint64)
    load().mc_gaec(n_nodes, len(uv), uv, costs, out)
    return out


def multicut_kernighan_lin(n_nodes: int, uv_ids: np.ndarray,
                           costs: np.ndarray, warmstart: bool = True,
                           max_passes: int = 50,
                           time_limit: float = 0.0) -> np.ndarray:
    """GAEC warmstart + Kernighan-Lin-style greedy node moves (the nifty
    multicutKernighanLin role: polish a partition with local search).
    ``time_limit`` (seconds, 0 = none) bounds the refinement passes — the
    reference's time-limited solver visitor (segmentation_utils.py:166-181);
    the warmstart always completes, so a valid partition is returned."""
    uv = _as_uv(uv_ids)
    costs = np.ascontiguousarray(costs, dtype=np.float64)
    labels = (multicut_gaec(n_nodes, uv, costs) if warmstart
              else np.zeros(n_nodes, dtype=np.uint64))
    labels = np.ascontiguousarray(labels, dtype=np.uint64)
    load().mc_kl_refine(n_nodes, len(uv), uv, costs, labels, max_passes,
                        float(time_limit or 0.0))
    return labels


def multicut_objective(uv_ids: np.ndarray, costs: np.ndarray,
                       labels: np.ndarray) -> float:
    """Sum of costs over cut edges (the minimized energy)."""
    uv = _as_uv(uv_ids)
    cut = labels[uv[:, 0]] != labels[uv[:, 1]]
    return float(np.asarray(costs)[cut].sum())


# ---------------------------------------------------------------------------
# mutex watershed
# ---------------------------------------------------------------------------

def mutex_clustering(n_nodes: int, uv_attractive: np.ndarray,
                     w_attractive: np.ndarray, uv_mutex: np.ndarray,
                     w_mutex: np.ndarray) -> np.ndarray:
    """Kruskal-style mutex watershed over explicit edge lists
    (affogato compute_mws_clustering equivalent): attractive and mutex
    edges jointly in descending weight order (a stable sort, attractive
    before mutex on ties)."""
    uva = _as_uv(uv_attractive)
    uvm = _as_uv(uv_mutex)
    wa = np.ascontiguousarray(w_attractive, dtype=np.float64)
    wm = np.ascontiguousarray(w_mutex, dtype=np.float64)
    if len(wa) != len(uva) or len(wm) != len(uvm):
        raise ValueError("one weight per edge needed")
    out = np.empty(n_nodes, dtype=np.uint64)
    load().mws_clustering(n_nodes, len(uva), uva, wa, len(uvm), uvm, wm, out)
    return out


def mutex_clustering_sorted(n_nodes: int, u: np.ndarray, v: np.ndarray,
                            mutex_flag: np.ndarray) -> np.ndarray:
    """Mutex-watershed union-find scan over a PRE-SORTED edge stream
    (descending priority; the device extracted and sorted the edges).
    ``u[i] < 0`` marks dropped edges; ``mutex_flag[i] != 0`` marks mutex
    edges."""
    u = np.ascontiguousarray(u, dtype=np.int32)
    v = np.ascontiguousarray(v, dtype=np.int32)
    mutex_flag = np.ascontiguousarray(mutex_flag, dtype=np.uint8)
    if not len(u) == len(v) == len(mutex_flag):
        raise ValueError("u, v and mutex_flag need one entry per edge")
    out = np.empty(n_nodes, dtype=np.uint64)
    load().mws_clustering_sorted(n_nodes, len(u), u, v, mutex_flag, out)
    return out


# ---------------------------------------------------------------------------
# lifted multicut
# ---------------------------------------------------------------------------

def lifted_multicut_gaec(n_nodes: int, uv_ids: np.ndarray, costs: np.ndarray,
                         lifted_uv_ids: np.ndarray,
                         lifted_costs: np.ndarray) -> np.ndarray:
    """Greedy additive contraction for the lifted multicut objective
    (nifty liftedMulticutGreedyAdditive equivalent): only local edges are
    contracted; priorities include the lifted cost between components."""
    uv = _as_uv(uv_ids)
    luv = _as_uv(lifted_uv_ids)
    c = np.ascontiguousarray(costs, dtype=np.float64)
    lc = np.ascontiguousarray(lifted_costs, dtype=np.float64)
    if len(c) != len(uv) or len(lc) != len(luv):
        raise ValueError("one cost per edge needed")
    out = np.empty(n_nodes, dtype=np.uint64)
    load().lmc_gaec(n_nodes, len(uv), uv, c, len(luv), luv, lc, out)
    return out


def lifted_multicut_kernighan_lin(n_nodes: int, uv_ids: np.ndarray,
                                  costs: np.ndarray,
                                  lifted_uv_ids: np.ndarray,
                                  lifted_costs: np.ndarray,
                                  warmstart: bool = True,
                                  max_passes: int = 50,
                                  time_limit: float = 0.0) -> np.ndarray:
    """Lifted GAEC warmstart + KL-style node moves over the lifted objective
    (nifty liftedMulticutKernighanLin equivalent)."""
    uv = _as_uv(uv_ids)
    luv = _as_uv(lifted_uv_ids)
    c = np.ascontiguousarray(costs, dtype=np.float64)
    lc = np.ascontiguousarray(lifted_costs, dtype=np.float64)
    labels = (lifted_multicut_gaec(n_nodes, uv, c, luv, lc) if warmstart
              else np.zeros(n_nodes, dtype=np.uint64))
    labels = np.ascontiguousarray(labels, dtype=np.uint64)
    load().lmc_kl_refine(n_nodes, len(uv), uv, c, len(luv), luv, lc, labels,
                         max_passes, float(time_limit or 0.0))
    return labels


def lifted_objective(uv_ids: np.ndarray, costs: np.ndarray,
                     lifted_uv_ids: np.ndarray, lifted_costs: np.ndarray,
                     labels: np.ndarray) -> float:
    """Sum of local and lifted costs over cut pairs (the minimized
    energy)."""
    uv = _as_uv(uv_ids)
    luv = _as_uv(lifted_uv_ids)
    e = float(np.asarray(costs)[labels[uv[:, 0]] != labels[uv[:, 1]]].sum())
    if len(luv):
        e += float(np.asarray(lifted_costs)[
            labels[luv[:, 0]] != labels[luv[:, 1]]].sum())
    return e


# ---------------------------------------------------------------------------
# agglomerative clustering
# ---------------------------------------------------------------------------

def agglomerative_clustering(n_nodes: int, uv_ids: np.ndarray,
                             edge_weights: np.ndarray,
                             edge_sizes: Optional[np.ndarray] = None,
                             node_sizes: Optional[np.ndarray] = None,
                             threshold: float = 0.5,
                             size_regularizer: float = 0.0) -> np.ndarray:
    """Edge-weighted agglomeration of a RAG: merge the lowest size-weighted
    mean boundary weight while it is below ``threshold``
    (nifty.graph.agglo edgeWeighted/mala cluster-policy equivalent,
    reference: utils/segmentation_utils.py:298-321).  Returns dense
    labels."""
    uv = _as_uv(uv_ids)
    w = np.ascontiguousarray(edge_weights, dtype=np.float64)
    es = np.ascontiguousarray(
        edge_sizes if edge_sizes is not None else np.ones(len(uv)),
        dtype=np.float64)
    ns = np.ascontiguousarray(
        node_sizes if node_sizes is not None else np.ones(n_nodes),
        dtype=np.float64)
    if not len(w) == len(es) == len(uv) or len(ns) != n_nodes:
        raise ValueError("one weight and size per edge and one size per "
                         "node needed")
    out = np.empty(n_nodes, dtype=np.uint64)
    load().agglomerate_edge_weighted(n_nodes, len(uv), uv, w, es, ns,
                                     float(threshold),
                                     float(size_regularizer), out)
    return out


# ---------------------------------------------------------------------------
# graph watershed
# ---------------------------------------------------------------------------

def graph_watershed(n_nodes: int, uv_ids: np.ndarray, edge_weights: np.ndarray,
                    seeds: np.ndarray, grow_smallest_first: bool = True
                    ) -> np.ndarray:
    """Seeded watershed on a graph (nifty edgeWeightedWatershedsSegmentation
    equivalent): the seed labels grow along the largest edge weights first;
    ``grow_smallest_first=True`` negates the weights, flooding across the
    lowest boundary evidence first (the reference's convention with
    probability weights, postprocess/graph_watershed_assignments.py:172)."""
    uv = _as_uv(uv_ids)
    w = np.ascontiguousarray(edge_weights, dtype=np.float64)
    if len(w) != len(uv):
        raise ValueError("one weight per edge needed")
    if len(seeds) != n_nodes:
        raise ValueError("one seed entry per node needed")
    if grow_smallest_first:
        w = -w
    out = np.ascontiguousarray(seeds, dtype=np.uint64).copy()
    load().graph_watershed(n_nodes, len(uv), uv, w, out)
    return out


# ---------------------------------------------------------------------------
# host watershed
# ---------------------------------------------------------------------------

def seeded_watershed_u8(height: np.ndarray, seeds: np.ndarray) -> np.ndarray:
    """Seeded 3d priority-flood watershed over a uint8 height map — the
    vigra ``watershedsNew`` algorithm (reference: utils/volume_utils.py:124)
    as a C++ monotone bucket-queue flood.  Returns int64 labels (seeds
    preserved, every seed-connected voxel labeled, 6-connectivity;
    negative seeds are barriers the flood never enters)."""
    if height.ndim != 3:
        raise ValueError("seeded_watershed_u8 expects a 3d volume")
    hq = np.ascontiguousarray(height, dtype=np.uint8)
    labels = np.ascontiguousarray(seeds, dtype=np.int64).copy()
    if labels.shape != hq.shape:
        raise ValueError("seeds and height need the same shape")
    load().seeded_watershed_u8(hq, *hq.shape, labels)
    return labels


def size_filter_u8(height: np.ndarray, labels: np.ndarray,
                   min_size: int) -> np.ndarray:
    """Remove fragments below ``min_size`` and regrow their voxels from
    the surviving neighborhood by a LOCAL priority flood (touches only the
    removed voxels; the reference regrows with a second full watershed)."""
    if height.ndim != 3:
        raise ValueError("size_filter_u8 expects a 3d volume")
    hq = np.ascontiguousarray(height, dtype=np.uint8)
    out = np.ascontiguousarray(labels, dtype=np.int64).copy()
    if out.shape != hq.shape:
        raise ValueError("labels and height need the same shape")
    load().size_filter_u8(hq, *hq.shape, out, int(min_size))
    return out


# ---------------------------------------------------------------------------
# skeletonization
# ---------------------------------------------------------------------------

def skeletonize_3d(volume: np.ndarray) -> np.ndarray:
    """Thin a 3d binary volume to a 1-voxel skeleton by topological
    border-peeling (skimage skeletonize_3d equivalent; the reference's
    skeletons component uses that — skeletons/skeletonize.py:129-157)."""
    if volume.ndim != 3:
        raise ValueError("skeletonize_3d expects a 3d volume")
    vol = np.ascontiguousarray(volume != 0, dtype=np.uint8)
    load().skeletonize_3d(vol, *vol.shape)
    return vol.astype(bool)
