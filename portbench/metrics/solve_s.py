"""Seconds of the host graph solve per volume: the walls of the tasks
``solve_subproblems_s0``, ``reduce_problem_s0`` and ``solve_global``."""


def read(trace):
    vols = trace.info.get("volumes")
    rows = [r for p in ("solve_subproblems", "reduce_problem",
                        "solve_global") for r in trace.task(p)]
    if not rows or not vols:
        return None
    return sum(float(r["wall_time"]) for r in rows) / vols
