"""The share of the traced window in which no device operation runs and no
stage span of the port's telemetry is open on any thread, in %: the
time in which the card idles and the port cannot say why."""


def read(trace):
    window = trace.window_s
    stages = [(a, b) for _, cat, a, b in trace.spans if cat == "stage"]
    if window <= 0 or not stages:
        return None
    named = stages + [(a, b) for _, a, b in trace.device_ops]
    clipped = [(max(a, 0.0), min(b, window)) for a, b in named]
    covered, end = 0.0, 0.0
    for a, b in sorted(iv for iv in clipped if iv[1] > iv[0]):
        if b > end:
            covered += b - max(a, end)
            end = b
    return 100.0 * (1.0 - covered / window)
