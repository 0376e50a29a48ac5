"""The run's peak of allocated device memory
(``torch.cuda.max_memory_allocated``), in GB."""


def read(trace):
    peak = trace.info.get("peak_bytes")
    return peak / 1e9 if peak else None
