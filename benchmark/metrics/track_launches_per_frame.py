"""Launch calls a frame in the point tracker: the host's kernel launches,
asynchronous copies and memsets of the traced run's profiled pass inside
the program's `track` span and its children, over the frames of the
pass's `video` spans.

Reads nothing until the traced run sets `Record.program` and
`Record.program_profile` (`harness/program_trace.py`)."""
from benchmark.harness import program_trace


def read(record):
    return program_trace.reading(record, "launches", "track", "frames")
