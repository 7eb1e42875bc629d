"""Launch calls a decoder pass: the host's kernel launches, asynchronous
copies and memsets of the traced run's profiled pass inside the
program's `decode.chunk` spans, over the decoder passes those spans
counted.

Reads nothing until the traced run sets `Record.program` and
`Record.program_profile` (`harness/program_trace.py`)."""
from benchmark.harness import program_trace


def read(record):
    return program_trace.reading(record, "launches", "decode.chunk", "passes")
