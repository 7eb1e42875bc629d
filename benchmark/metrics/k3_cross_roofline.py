"""Share of its roofline that K3, the decoder's cross-attention, both directions reaches in the traced
run's profiled pass: the sum over its launches of the least time the H100
could take (`flops.cross_launch`, from each launch's shapes) over the sum of the
profiler's device time of its kernels (cross_attention_t2i_kernel, cross_attention_i2t_kernel)."""
from benchmark.harness import flops

KERNELS = ('cross_attention_t2i_kernel', 'cross_attention_i2t_kernel')


def read(record):
    launches = record.launches.get("cross")
    if not launches or record.profile is None:
        return None
    device_s = sum(s for name, s in record.profile["by_name"].items()
                   if any(k in name for k in KERNELS))
    if device_s <= 0:
        return None
    bound_s = sum(flops.cross_launch(*shape)["bound_s"] for shape in launches)
    return 100.0 * bound_s / device_s
