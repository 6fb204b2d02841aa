"""mfu.train (%): the model FLOPs of a training step's clips (the
reference's forward under FlopCounterMode, x 3) times the window's clips/s,
over the card's peak at the configuration's precision."""


def read(trace):
    c = trace.counters
    if not c.get("train_flop_per_clip") or not c.get("clips_per_s"):
        return None
    return 100.0 * c["train_flop_per_clip"] * c["clips_per_s"] / c["peak_flop_s"]
