"""attn_roofline.train (%): the attention's least time in the profiled
training steps over its kernels' device time (kernels matched as
attn_share.train matches them).

The least time is the larger of the attention products' operations at
3xTF32 (three TF32 products a float32 one, at the TF32 peak: the fastest
float32-accurate route on the card) and their bytes at the memory rate,
from the family's ``attention_work`` (forward and backward, a clip) x the
batch x the profiled steps (one fbank launch a step). The configuration is
that of the one cell this metric lists in BENCHMARK.json."""

import re

from benchmark import harness, work
from benchmark.reference.training import family

ATTENTION = re.compile(r"fmha|flash|attention", re.I)  # as attn_share.train's
NAME = "attn_roofline.train"


def read(trace):
    spent = sum(s for name, s in trace.ops if ATTENTION.search(name))
    steps = trace.counters.get("fbank_launches")
    if spent <= 0 or not steps:
        return None
    manifest = harness.load_json(harness.ROOT / "BENCHMARK.json")
    (cell,) = next(m for m in manifest["per_layer"] if m["name"] == NAME)["workloads"]
    config = harness.cell(cell, manifest).config
    w = family(config["family"]).attention_work(config)
    clips = steps * config["batch_size"]
    bound = clips * max(3.0 * w["flop"] / work.peak_flop_s("tf32"),
                        w["bytes"] / work.PEAK_BYTES_S)
    return 100.0 * bound / spent
