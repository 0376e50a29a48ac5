"""First-party native kernels (C++), loaded via ctypes.

Replaces the reference's external pybind11 wheels for combinatorial work
(nifty solvers/ufd — SURVEY §2.3).  The shared library is compiled with g++
from ``src/solvers.cpp`` the first time a process needs it (the C API is
flat arrays; see ``core/build.py``).  Without a compiler the solvers raise:
the package has no slower stand-in for them.
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
_CMD = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """Build (at first use) and load the solver library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build_shared("ctt_torch_native", [_SRC], _CMD))
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
        _lib = lib
        return _lib


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
