"""The EDT's share of its bytes roofline: the least bytes of every
block's EDT (8 B per outer-block voxel per axis, 3 axes; refs/cost.py)
at the H100's 3.35 TB/s, over the device time of the kernels named
``minplus`` in the trace, in %."""

from portbench.refs.cost import PEAK_HBM_BYTES, edt_bytes


def read(trace):
    t = trace.kernel_s("minplus")
    outer = trace.info.get("outer_shape")
    blocks = trace.info.get("n_blocks")
    if not t or not outer or not blocks:
        return None
    return 100.0 * blocks * edt_bytes(outer) / PEAK_HBM_BYTES / t
