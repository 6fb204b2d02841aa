"""The comparison that decides ``correct`` at a size a test run holds, on
the CPU: a sound run of each cell comes out correct; the control (the
reference put in the program's place at the precision below the cell's)
fails a cell's limits; and a run with the timed path broken underneath
comes out not correct, once for each fault the cell can have. The cells'
own limits are used unchanged. The program computes its fbank by the
kernel's plain version (float64 spectrum), the kernel's precision on the
card."""

import dataclasses
import time

import pytest
import torch

import psla_tpu_torch.train.step as step_module
from benchmark import control, harness, program
from benchmark.drivers import train

TINY = dict(eff_b=0, n_class=10, target_length=64, freqm=8, timem=16)
SEED = 2**31 + 101


@pytest.fixture(autouse=True)
def kernel_precision(monkeypatch):
    plain = program.preprocess_config
    monkeypatch.setattr(program, "preprocess_config",
                        lambda c: dataclasses.replace(plain(c), fbank_method="fft64"))


CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


def tiny(name: str) -> harness.Cell:
    c = harness.cell(name)
    c.config.update(TINY, batch_size=4)
    return c


def run_train(c: harness.Cell) -> harness.Outcome:
    return train.run(c, seed=SEED, seconds=1.0, traced=False, t0=time.perf_counter(),
                     device="cpu")


def correct(c: harness.Cell, out: harness.Outcome) -> bool:
    return harness.result(c, out, False)["correct"]


def failing(readings: dict, limits: dict) -> list[str]:
    return [k for k, v in readings.items() if k in limits and v > limits[k]]


# ------------------------------------------------------------------ training


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_training_run_is_correct(name):
    c = tiny(name)
    out = run_train(c)
    assert correct(c, out), out.checks


def _unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    build = step_module.build_train_step

    def halved(*a, **k):
        inner = build(*a, **k)

        def step(state, batch, draws):
            rows = len(batch["wav"]) // 2
            batch = {k: v[:rows] for k, v in batch.items()}
            pre = step_module.PreprocessDraws(*(None if d is None else type(d)(
                *(t[:rows] for t in d)) for d in draws.pre))
            keep = None if draws.keep is None else draws.keep[:, :rows]
            return inner(state, batch, step_module.TrainDraws(pre, keep))
        return step
    monkeypatch.setattr(train, "build_train_step", halved)


def _altered(monkeypatch):
    loss = step_module.bce_loss
    monkeypatch.setattr(step_module, "bce_loss", lambda p, t: loss(p, t) * 1.01)


@pytest.mark.parametrize("plant", [_unchanged, _half_batch, _altered],
                         ids=["unchanged", "half_batch", "altered"])
def test_a_broken_training_step_is_not_correct(plant, monkeypatch):
    plant(monkeypatch)
    c = tiny("audioset_full.train")
    out = run_train(c)
    assert not correct(c, out), out.checks


@pytest.mark.parametrize("name", CELLS)
def test_the_training_control_and_faults_fail_the_limits(name):
    c = tiny(name)
    readings = control.train_readings(c, SEED, torch.device("cpu"))
    assert set(readings) == {"control", "half_batch", "altered", "unchanged"}
    for reading, numbers in readings.items():
        assert failing(numbers, c.workload["limits"]), (reading, numbers)
