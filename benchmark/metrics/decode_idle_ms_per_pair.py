"""Milliseconds an (object, frame) pair that the device idles while the
host is in the decode chain: the idle gaps of the traced run's profiled
pass given to the program's `decode` and `decode.chunk` spans over the
pairs of the pass's `video` spans.

Reads nothing until the traced run sets `Record.program` and
`Record.program_profile` (`harness/program_trace.py`)."""
from benchmark.harness import program_trace


def read(record):
    value = program_trace.reading(record, "gaps", "decode", "pairs")
    return None if value is None else 1e3 * value
