"""Seconds of the storage layer's ``store-io`` stage (a chunk's file
written and renamed into place), summed over every task's status JSON (a
load over the writer threads, not a wall), per volume."""


def read(trace):
    vols = trace.info.get("volumes")
    vals = [float(s["stages"]["store-io"]) for s in trace.status
            if "store-io" in s.get("stages", {})]
    if not vals or not vols:
        return None
    return sum(vals) / vols
