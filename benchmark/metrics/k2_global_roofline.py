"""Share of its roofline that K2, the encoder's global attention reaches in the traced
run's profiled pass: the sum over its launches of the least time the H100
could take (`flops.global_launch`, from each launch's shapes) over the sum of the
profiler's device time of its kernels (relpos_flash_kernel)."""
from benchmark.harness import flops

KERNELS = ('relpos_flash_kernel',)


def read(record):
    launches = record.launches.get("global")
    if not launches or record.profile is None:
        return None
    device_s = sum(s for name, s in record.profile["by_name"].items()
                   if any(k in name for k in KERNELS))
    if device_s <= 0:
        return None
    bound_s = sum(flops.global_launch(*shape)["bound_s"] for shape in launches)
    return 100.0 * bound_s / device_s
