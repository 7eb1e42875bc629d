"""The port's point trackers (counterpart of
`sam_pt_tpu/models/tracker/__init__.py`): CoTracker, PIPS, PIPS++, RAFT,
SuperGlue, TAPIR and TapNet."""
from .api import PointTracker
from .cotracker.tracker import CoTrackerPointTracker
from .pips.tracker import PipsPointTracker
from .pips2.tracker import PipsPlusPlusPointTracker
from .raft.tracker import RaftPointTracker
from .superglue.tracker import SuperGluePointTracker
from .tapir.tracker import TapirPointTracker
from .tapnet.tracker import TapNetPointTracker

TRACKER_REGISTRY = {
    "cotracker": CoTrackerPointTracker,
    "pips": PipsPointTracker,
    "pips_plus_plus": PipsPlusPlusPointTracker,
    "raft": RaftPointTracker,
    "superglue": SuperGluePointTracker,
    "tapir": TapirPointTracker,
    "tapnet": TapNetPointTracker,
}
