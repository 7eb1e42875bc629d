"""Milliseconds a frame that the device idles while the host is in SAM's
encode: the idle gaps of the traced run's profiled pass given to the
program's `encode` and `encode.chunk` spans over the frames of the
pass's `video` spans.

Reads nothing until the traced run sets `Record.program` and
`Record.program_profile` (`harness/program_trace.py`)."""
from benchmark.harness import program_trace


def read(record):
    value = program_trace.reading(record, "gaps", "encode", "frames")
    return None if value is None else 1e3 * value
