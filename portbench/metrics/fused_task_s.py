"""Seconds of the fused device pass's task (``wall_time`` of the task
``fused_segmentation`` in the job's status JSONs), per volume."""


def read(trace):
    rows = trace.task("fused_segmentation")
    vols = trace.info.get("volumes")
    if not rows or not vols:
        return None
    return sum(float(r["wall_time"]) for r in rows) / vols
