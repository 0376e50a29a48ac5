"""The device's idle share of the traced window: 1 - the union of the
device operations' intervals in the profiler trace over the window, in %."""


def read(trace):
    if trace.window_s <= 0 or not trace.device_ops:
        return None
    return 100.0 * (1.0 - trace.busy_s(0.0, trace.window_s)
                    / trace.window_s)
