"""The training window's share of the H100's bfloat16 dense peak
(989 TFLOP/s at 700 W): 3 x the forward FLOP of the batch per step
(refs/cost.py) x the steps, over the traced window, in %."""

from portbench.refs.cost import PEAK_BF16_FLOPS


def read(trace):
    flop, steps = trace.info.get("step_flop"), trace.info.get("steps")
    if not flop or not steps or trace.window_s <= 0:
        return None
    return 100.0 * flop * steps / trace.window_s / PEAK_BF16_FLOPS
