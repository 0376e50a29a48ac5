"""Seconds of the host graph tasks between the fused pass and the solve:
the stages ``host-assemble`` (face assembly), ``host-merge`` (the global
graph), ``host-map-ids`` (edge ids), ``host-features`` (the feature
table) and ``host-costs``, summed over every task's status JSON, per
volume."""

STAGES = ("host-assemble", "host-merge", "host-map-ids", "host-features",
          "host-costs")


def read(trace):
    vols = trace.info.get("volumes")
    vals = [float(s["stages"][n]) for s in trace.status for n in STAGES
            if n in s.get("stages", {})]
    if not vals or not vols:
        return None
    return sum(vals) / vols
