"""Interactive proofreading: incremental re-segmentation.

Port of cluster_tools_tpu/edits/ (host only: numpy and the package's C++
solvers).

The "millions of users" scenario is not whole-volume jobs — it is
proofreaders issuing merge/split edits and expecting sub-second
turnaround.  The hierarchical blockwise multicut (Pape et al., ICCV'17
Workshops) makes that locally re-solvable: outer edges of every
subproblem are always cut before the reduce step, so a block's solution
depends only on its inner edge costs, and an edit — a +/- attractive
bias on the edges between the edited fragments — invalidates exactly
the subproblems whose blocks contain at least two of those fragments.

Modules:

* :mod:`.log`          append-only, replayable merge/split records
* :mod:`.resolver`     fragment ids -> affected subproblem blocks
* :mod:`.incremental`  warm-started, signature-validated re-solve
* :mod:`.patcher`      stable LUT delta + touched-block rewrite
* :mod:`.service`      the server-facing ``edit`` lane pipeline
"""

from .log import EditLog, EditRecord
from .resolver import resolve_affected
from .incremental import EditSession
from .patcher import patch_assignment_table, stable_relabel
from .service import EditPipeline

__all__ = [
    "EditLog", "EditRecord", "resolve_affected", "EditSession",
    "patch_assignment_table", "stable_relabel", "EditPipeline",
]
