"""fbank_roofline.train (%): the fbank kernel's least time over the
profiled steps' batches (``benchmark/work.fbank_bound``: operations at the
float32 peak or bytes at the memory rate, the larger) over its device time
there."""

from benchmark.work import kernel_group


def read(trace):
    spent = [s for name, s in trace.ops if kernel_group(name) == "fbank kernel"]
    bound = trace.counters.get("fbank_bound_s")
    if not spent or not bound or len(spent) != trace.counters.get("fbank_launches"):
        return None
    return 100.0 * bound / sum(spent)
