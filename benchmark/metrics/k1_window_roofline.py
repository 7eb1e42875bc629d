"""Share of its roofline that K1, the encoder's windowed attention reaches in the traced
run's profiled pass: the sum over its launches of the least time the H100
could take (`flops.window_launch`, from each launch's shapes) over the sum of the
profiler's device time of its kernels (relpos_window_kernel)."""
from benchmark.harness import flops

KERNELS = ('relpos_window_kernel',)


def read(record):
    launches = record.launches.get("window")
    if not launches or record.profile is None:
        return None
    device_s = sum(s for name, s in record.profile["by_name"].items()
                   if any(k in name for k in KERNELS))
    if device_s <= 0:
        return None
    bound_s = sum(flops.window_launch(*shape)["bound_s"] for shape in launches)
    return 100.0 * bound_s / device_s
