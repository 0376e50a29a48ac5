"""Seconds of the storage layer's ``store-encode`` stage (a chunk's codec:
the gzip of the uint64 labels), summed over every task's status JSON (a
load over the writer threads, not a wall), per volume."""


def read(trace):
    vols = trace.info.get("volumes")
    vals = [float(s["stages"]["store-encode"]) for s in trace.status
            if "store-encode" in s.get("stages", {})]
    if not vals or not vols:
        return None
    return sum(vals) / vols
