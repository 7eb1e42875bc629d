"""The port's point trackers (counterpart of
`sam_pt_tpu/models/tracker/__init__.py`): CoTracker, PIPS, PIPS++ and
RAFT. TAPIR, TapNet and SuperGlue are not ported yet."""
from .api import PointTracker
from .cotracker.tracker import CoTrackerPointTracker
from .pips.tracker import PipsPointTracker
from .pips2.tracker import PipsPlusPlusPointTracker
from .raft.tracker import RaftPointTracker

TRACKER_REGISTRY = {
    "cotracker": CoTrackerPointTracker,
    "pips": PipsPointTracker,
    "pips_plus_plus": PipsPlusPlusPointTracker,
    "raft": RaftPointTracker,
}
