"""Milliseconds a object of the spanned videos in the host query sampling (`SamPt.extract_query_points`: k-medoids positives, mixed negatives): the seconds of its span in
the traced run's spanned pass (each call between two synchronisations)
over the objects of that pass."""


def read(record):
    seconds = record.spans.get("query")
    work = record.work.get("objects")
    if seconds is None or not work:
        return None
    return 1e3 * seconds / work
