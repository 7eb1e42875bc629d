"""The port's point trackers (counterpart of
`sam_pt_tpu/models/tracker/__init__.py`): CoTracker, PIPS, PIPS++, RAFT,
TAPIR and TapNet. SuperGlue is not ported yet."""
from .api import PointTracker
from .cotracker.tracker import CoTrackerPointTracker
from .pips.tracker import PipsPointTracker
from .pips2.tracker import PipsPlusPlusPointTracker
from .raft.tracker import RaftPointTracker
from .tapir.tracker import TapirPointTracker
from .tapnet.tracker import TapNetPointTracker

TRACKER_REGISTRY = {
    "cotracker": CoTrackerPointTracker,
    "pips": PipsPointTracker,
    "pips_plus_plus": PipsPlusPlusPointTracker,
    "raft": RaftPointTracker,
    "tapir": TapirPointTracker,
    "tapnet": TapNetPointTracker,
}
