"""Seconds a submitting thread sat blocked on an unfinished writer-pool
task (the ``pool-wait`` stage: a full in-flight window, or a drain),
summed over every task's status JSON, per volume."""


def read(trace):
    vols = trace.info.get("volumes")
    vals = [float(s["stages"]["pool-wait"]) for s in trace.status
            if "pool-wait" in s.get("stages", {})]
    if not vals or not vols:
        return None
    return sum(vals) / vols
