"""Seconds of the storage layer's ``store-write`` stage, summed over every
task's status JSON (a load over the writer threads, not a wall), per
volume."""


def read(trace):
    vols = trace.info.get("volumes")
    vals = [float(s["stages"]["store-write"]) for s in trace.status
            if "store-write" in s.get("stages", {})]
    if not vals or not vols:
        return None
    return sum(vals) / vols
