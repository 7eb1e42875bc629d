"""Milliseconds a frame in HQ-SAM's image-level features
(`SamPt._hq_features_device`, once a frame): the seconds of its span in the
traced run's spanned pass (each call between two synchronisations) over
the frames of that pass. None where the run has no such span (plain SAM,
or a program without the step)."""


def read(record):
    seconds = record.spans.get("hq")
    work = record.work.get("frames")
    if seconds is None or not work:
        return None
    return 1e3 * seconds / work
