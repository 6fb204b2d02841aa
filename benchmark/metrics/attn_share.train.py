"""attn_share.train (%): the attention kernels' share of the device time in
the profiled training steps. An attention kernel is one whose name matches
``ATTENTION`` (PyTorch's SDPA kernels: ``fmha_cutlassF``/``fmha_cutlassB``
of its memory-efficient attention, ``flash_fwd``/``flash_bwd``)."""

import re

ATTENTION = re.compile(r"fmha|flash|attention", re.I)


def read(trace):
    total = sum(s for _, s in trace.ops)
    attn = sum(s for name, s in trace.ops if ATTENTION.search(name))
    if total <= 0 or attn <= 0:
        return None
    return 100.0 * attn / total
