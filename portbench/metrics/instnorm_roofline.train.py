"""The InstanceNorm kernels' share of their bytes roofline: the least
bytes of a step's InstanceNorms (10 B per bfloat16 value, forward and
backward; ``refs/swin_cost.py``) x the steps at the H100's 3.35 TB/s, over
the device time of the kernels named ``groupnorm_`` in the trace (the
pair of ``csrc/groupnorm.cu``; the Swin cell runs no GELU instance), in
%."""

from portbench.refs.cost import PEAK_HBM_BYTES


def read(trace):
    t = trace.kernel_s("groupnorm_")
    nbytes, steps = trace.info.get("norm_bytes"), trace.info.get("steps")
    if not t or not nbytes or not steps:
        return None
    return 100.0 * nbytes * steps / PEAK_HBM_BYTES / t
