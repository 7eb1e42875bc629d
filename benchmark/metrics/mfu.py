"""The whole step's share of the H100's bf16 peak: the model FLOPs of the
videos of the traced run's plain part (the configuration's reference's
`video_flops`; SAM-PT's: the encoder, the tracker and every decoder pass
at its own token count) over that
part's wall time times 989 TFLOP/s, in percent. The plain part runs
without spans or the profiler, so nothing slowed its wall."""
from benchmark.harness import flops


def read(record):
    model = record.model
    if not model or model["wall"] <= 0:
        return None
    return 100.0 * model["flops"] / (model["wall"] * flops.PEAK_BF16_FLOP_S)
