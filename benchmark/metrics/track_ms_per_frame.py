"""Milliseconds a frame in the point tracker (`SamPt._track_points_device`): the seconds of its span in
the traced run's spanned pass (each call between two synchronisations)
over the frames of that pass."""


def read(record):
    seconds = record.spans.get("track")
    work = record.work.get("frames")
    if seconds is None or not work:
        return None
    return 1e3 * seconds / work
