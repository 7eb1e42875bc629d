"""Milliseconds a (frame, object) pair in the decode chain (`SamPt._apply_sam_device`): the seconds of its span in
the traced run's spanned pass (each call between two synchronisations)
over the pairs of that pass."""


def read(record):
    seconds = record.spans.get("decode")
    work = record.work.get("pairs")
    if seconds is None or not work:
        return None
    return 1e3 * seconds / work
