"""Milliseconds per block in which the device was busy while the task
``fused_segmentation`` ran (its span in the port's telemetry), from the
profiler's device trace."""


def read(trace):
    span = trace.task_span("fused_segmentation")
    blocks = trace.info.get("n_blocks")
    if span is None or not blocks:
        return None
    busy = trace.busy_s(*span)
    return busy * 1e3 / blocks if busy > 0 else None
