"""bn_share.train (%): BatchNorm's kernels' share of the device time in the
profiled training steps, by the kernel groups of ``benchmark/work.py``."""

from benchmark.work import kernel_group


def read(trace):
    total = sum(s for _, s in trace.ops)
    if total <= 0:
        return None
    bn = sum(s for name, s in trace.ops if kernel_group(name).startswith("BatchNorm"))
    return 100.0 * bn / total
