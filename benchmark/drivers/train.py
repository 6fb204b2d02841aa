"""The one-card training cell: the configuration's train step
(``train.step.build_train_step``) fed by ``data.device_prefetch`` from a
seeded pool of host batches, for a window of ``seconds``.

Set-up builds the state (model, Adam, schedule past warmup) from the
benchmark's weights and drives it through the workload's
``checked_steps`` steps, by the window's own call and feed, on batches of
distinct clips; the program's first gradient (its Adam first moment after
one step) and every parameter's change after those steps are read as
norms, and the same state runs on into the window. Once the window has
closed, the peak memory read and the program's state freed, the reference
repeats the checked steps from the same weights, batches and draws
(``compare.train_checks``).

``values``: ``clips_per_s`` (all clips of the window over all its time),
``steps``. A traced run profiles ``profile_steps`` steps a third of the
way into the window.
"""

from __future__ import annotations

import itertools
import time

import torch

from benchmark import compare, harness, program, traffic, work
from benchmark.reference import training
from benchmark.weights import make_weights
from psla_tpu_torch.data.device_prefetch import prefetch_to_device
from psla_tpu_torch.train.state import create_train_state
from psla_tpu_torch.train.step import build_train_step


def setup_state(config: dict, weights: dict, start_step: int, dev):
    model = program.model(config, weights)
    return create_train_state(model, program.schedule(config), step=start_step, device=dev)


def read_first_gradient(state) -> dict[str, float]:
    """Norms of the gradient as Adam took it on its first step: its first
    moment over (1 - beta1) (zero where it holds none)."""
    beta1 = state.optimizer.param_groups[0]["betas"][0]
    moments = {k: state.optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
               for k, p in state.model.named_parameters()}
    return compare.norms({k: m / (1.0 - beta1) for k, m in moments.items()})


def read_changes(state, weights: dict) -> dict[str, float]:
    return compare.norms({k: p.detach() - weights[k]
                          for k, p in state.model.named_parameters()})


def host_to_tensors(batch: dict, dev) -> dict:
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def train_counters(config: dict, clips_per_s: float, profiled: list[dict]) -> dict:
    """What the per-layer metrics of a training cell read beside the trace:
    the window's rate, the work of a clip, and the fbank's least time over
    the profiled steps' batches (one launch a step)."""
    buffer = profiled[0]["wav"].shape[1]
    bound = sum(work.fbank_bound(b["length"], buffer, config["target_length"],
                                 config["num_mel_bins"], config["sample_rate"])["s"]
                for b in profiled)
    return {"clips_per_s": clips_per_s, "train_flop_per_clip": work.train_flop(config),
            "peak_flop_s": work.peak_flop_s(config["precision"]), "fbank_bound_s": bound,
            "fbank_launches": len(profiled)}


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool, t0: float,
        device: str = "cuda") -> harness.Outcome:
    wl, config = cell.workload, cell.config
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    batch = config["batch_size"]
    (weights,) = make_weights(config, seed, dev)
    state = setup_state(config, weights, wl["start_step"], dev)
    step = build_train_step(program.preprocess_config(config))
    pool = traffic.train_pool(wl["traffic"], config, batch, seed, dev)
    feed = prefetch_to_device(itertools.cycle(pool), dev, depth=wl["prefetch"])
    rates = training.family(config["family"]).drop_rates(config)

    def one_step():
        _, device_batch = next(feed)
        draws = program.make_draws(program.step_generator(seed, state.step, dev), batch, rates)
        with torch.profiler.record_function("bench.step"):
            _, out = step(state, device_batch, program.train_draws(draws))
        return draws, out["loss"]

    checked = {"draws": [], "losses": []}
    for i in range(wl["checked_steps"]):
        draws, loss = one_step()
        checked["draws"].append({k: v.clone() for k, v in draws.items()})
        checked["losses"].append(loss)
        if i == 0:
            checked["grads"] = read_first_gradient(state)
    checked["changes"] = read_changes(state, weights)
    checked["losses"] = [float(x) for x in checked["losses"]]
    for _ in range(wl["warm_steps"]):
        one_step()
    if traced:
        harness.warm_profiler(sync)
    sync()
    setup_s = time.perf_counter() - t0

    holder: list[harness.Trace] = []
    profile_at = seconds / 3 if traced else float("inf")
    losses, steps, profiled_from = [], 0, None
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        if time.perf_counter() - w0 >= profile_at and profiled_from is None:
            profiled_from = steps
            with harness.profiled(holder, sync):
                for _ in range(wl["profile_steps"]):
                    losses.append(one_step()[1])
            steps += wl["profile_steps"]
            continue
        losses.append(one_step()[1])
        steps += 1
    sync()
    elapsed = time.perf_counter() - w0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    clips_per_s = steps * batch / elapsed

    trace = None
    if traced:
        # the feed cycles through the pool from the first checked step
        first = wl["checked_steps"] + wl["warm_steps"] + profiled_from
        trace = holder[0]
        trace.counters = train_counters(
            config, clips_per_s, [pool[(first + j) % len(pool)]
                                  for j in range(wl["profile_steps"])])

    feed.close()
    del state, step, feed, losses
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    batches = [host_to_tensors(pool[i % len(pool)], dev) for i in range(wl["checked_steps"])]
    reference = training.train_steps(config, weights, batches, checked["draws"],
                                     wl["start_step"])
    checks, notes = compare.train_checks(checked, reference, wl["limits"])
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return harness.Outcome(values={"clips_per_s": clips_per_s, "steps": steps},
                           setup_s=setup_s, attempted=steps, failed=failed, checks=checks,
                           memory_peak_bytes=int(peak), device_kind=kind, device_count=1,
                           trace=trace, notes=notes)
