"""Data parallelism of the port (``psla_tpu_torch/parallel/``, the
``mesh`` forms of the train and eval steps, the multi-rank trainer and CLI,
and serving on several devices) on the CPU.

One two-rank gloo world a module (``world2``: spawned processes meeting at
a file store under the test's tmp dir) runs every world-2 check once, in
``tests/torch_distributed_worker.py``, and each test reads its part. The
references are the same functions at world 1 in this process, and flax's
BatchNorm under the JAX package's 2-device mesh (GSPMD).

Size: EffNetAttention(b=0), T=64, 2 steps with mixup, SpecAugment and
drop-connect. In float64: 4 heads, 4 classes, global batch 4 (2 a rank),
from the shared numpy-made variables (tests/torch_port_fixtures.py), and
the same with ``remat`` on the ranks, and in bfloat16. In
float32: tests/test_parallel.py's own case (``_setup``: 1 head, 6 classes,
masks of 4, BatchNorm momentum 0.5, the seeded fan-out init, one noise
batch of 8 taken twice), on which its bars were set.

Bars. A world-2 step is the one-process step on the global batch up to the
order of the sums: in float64, the loss within 1e-10 and the parameters
and running statistics within 1e-9; in float32, tests/test_parallel.py's
(90-100): the loss within 3e-4, the parameters max 3 x lr, mean |diff|
1e-5, 99th percentile 1e-4, and the running statistics within 1e-5 (on
the float64 case the float32 one-process step is itself 3.4e-3 from the
float64 one, in block 0's ``_bn2.bias``, whose gradient is zero but for the
padded borders and whose sign Adam turns into a step of lr). In bfloat16
the two steps part by what bf16 rounding, amplified through the train-mode
BatchNorms of batch-2 shards, makes of the different sum orders (measured:
loss 8.6e-3, statistics after step 1 2.3e-2, parameters mean 5.1e-4,
max 4 lr, Adam's own bound on two steps), held at twice that; those bars
would pass statistics taken in bf16 too. The stem's running statistics
after step 1 come before that amplification: within 3e-6 (measured
1.0e-6; a synced layer that takes its statistics in bf16 misses by
1.7e-4), and the synced layer itself in bf16 is held bit for bit. The
synced BatchNorm: the port's layer on the whole batch within 1e-6, flax's
``ReferenceBatchNorm`` under GSPMD within 1e-6 plus flax's own distance
from the float64 layer (tests/test_torch_train.py's bars). The eval gather:
the one-process ``validate`` rows within 1e-5. Serving on two devices: one
device within 1e-5 (tests/test_serve.py:197).
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch
import torch.multiprocessing

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from psla_tpu.models.layers import ReferenceBatchNorm
from psla_tpu.parallel.mesh import make_mesh as jax_make_mesh
from psla_tpu_torch import cli
from psla_tpu_torch.frontend.pipeline import PreprocessConfig
from psla_tpu_torch.models import create_model
from psla_tpu_torch.models.convert import CHECKPOINT_FILE, from_jax_variables
from psla_tpu_torch.models.layers import BN_EPS
from psla_tpu_torch.parallel import distributed
from psla_tpu_torch.parallel.mesh import make_mesh, shard_batch
from psla_tpu_torch.tools.serve import InferenceEngine
from psla_tpu_torch.train.state import create_train_state
from psla_tpu_torch.train.step import build_train_step
from tests import torch_distributed_worker as worker
from tests.synth import build_corpus
from tests.test_torch_augment import tone_batch
from tests.torch_port_fixtures import jax_variables, tmp_path  # noqa: F401

torch.set_num_threads(2)

WORLD, B, T, N_CLASS, HEADS, LR = 2, 4, 64, 4, 4, 1e-3
AUG = dict(freq_mask=48, time_mask=24, mixup_rate=0.5)
BN_SHAPE = (4, 8, 5, 6)  # NCHW


def _spec(root) -> dict:
    """Everything the ranks read: weights, batches, the BatchNorm's inputs,
    the corpus (16 tone clips; the val set its first 11, so the last
    batch of each rank is padded) and the CLI's arguments (the 11 clips as
    its train and val sets)."""
    n = PreprocessConfig(target_length=T).fbank.buffer_length(T)
    batches = []
    for seed in range(2):
        batch = tone_batch(60 + seed, n)
        batch["labels"] = np.eye(N_CLASS, dtype=np.float32)[(np.arange(B) + seed) % N_CLASS]
        batch["mix_labels"] = np.roll(batch["labels"], 1, 0)
        batches.append(batch)
    # tests/test_parallel.py's _setup
    rng = np.random.RandomState(0)
    wav = (0.1 * rng.randn(8, n)).astype(np.float32)
    labels = np.eye(6, dtype=np.float32)[rng.randint(6, size=8)]
    jax_batch = {"wav": wav, "wav_mean": wav.mean(1), "length": np.full(8, n, np.int32),
                 "labels": labels, "mix_wav": wav[::-1].copy(),
                 "mix_wav_mean": wav.mean(1)[::-1].copy(),
                 "mix_length": np.full(8, n, np.int32), "mix_labels": labels[::-1].copy()}
    cases = {
        "float64": dict(state_dict=from_jax_variables(jax_variables(HEADS, 21, N_CLASS),
                                                      N_CLASS),
                        batches=batches, aug=AUG, heads=HEADS, n_class=N_CLASS,
                        bn_momentum=0.99, lr=LR),
        "float32": dict(state_dict=create_model("efficientnet", label_dim=6, eff_b=0,
                                                head_num=1).state_dict(),
                        batches=[jax_batch, jax_batch], heads=1, n_class=6, bn_momentum=0.5,
                        aug=dict(freq_mask=4, time_mask=4, mixup_rate=0.5), lr=LR),
    }
    cases["bfloat16"] = cases["float64"]
    rng = np.random.default_rng(5)
    c = BN_SHAPE[1]
    bn_x = (rng.normal(0.0, 0.5, (1, c, 1, 1)) + rng.uniform(0.5, 2.0, (1, c, 1, 1))
            * rng.standard_normal(BN_SHAPE)).astype(np.float32)
    datafile, label_csv = build_corpus(str(root / "corpus"), num_classes=N_CLASS,
                                       clips_per_class=4, seconds=0.5)
    with open(datafile) as f:
        entries = json.load(f)["data"]
    val_file = str(root / "val.json")
    with open(val_file, "w") as f:
        json.dump({"data": entries[:11]}, f)
    cli_dir = str(root / "cli")
    return {
        "T": T, "cases": cases,
        "state_dict": cases["float64"]["state_dict"],
        "bn_x": bn_x, "bn_g": rng.standard_normal(BN_SHAPE).astype(np.float32),
        "bn_state": {"weight": torch.from_numpy(rng.uniform(0.8, 1.2, c).astype(np.float32)),
                     "bias": torch.from_numpy(rng.normal(0.0, 0.1, c).astype(np.float32)),
                     "running_mean": torch.from_numpy(rng.normal(0.0, 0.1, c).astype(np.float32)),
                     "running_var": torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))},
        "trainer_config": dict(
            data_train=datafile, data_val=val_file, label_csv=label_csv, n_class=N_CLASS,
            eff_b=0, att_head=HEADS, target_length=T, batch_size=B, num_workers=1,
            impretrain=False),
        "validate_dir": str(root / "validate2"),
        "cli_dir": cli_dir,
        "cli_argv": cli_argv(val_file, label_csv, cli_dir, "--dtype", "bfloat16",
                             "--act-compress", "q8save"),
    }


def cli_argv(datafile: str, label_csv: str, exp_dir: str, *extra) -> list[str]:
    """One epoch of B0 (one head, T=64) at global batch 4, weight averaging
    over it, on the CPU."""
    return ["--data-train", datafile, "--data-val", datafile, "--label-csv", label_csv,
            "--exp-dir", exp_dir, "--n_class", str(N_CLASS), "--eff_b", "0", "--att_head",
            "1", "--target_length", str(T), "-b", str(B), "-w", "1", "--lr", "1e-3",
            "--n-epochs", "1", "--wa_start", "1", "--wa_end", "1", "--warmup", "False",
            "--impretrain", "False", "--device", "cpu", *extra]


def sum_bar(ref) -> float:
    """1e-6 of the scale of a parameter gradient: a sum of 120 float32
    products, up to ~16 here, whose float32 spacing is ~1e-6 (the one-process
    layer is itself 7.8e-7 from the float64 sum)."""
    return 1e-6 * max(1.0, float(np.abs(np.asarray(ref)).max()))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The spec, each rank's results, and the one-process references
    (computed here while the ranks run); the files are removed after the
    module's tests."""
    root = tmp_path_factory.mktemp("world2")
    spec = _spec(root)
    spec_path = str(root / "spec.pt")
    torch.save(spec, spec_path)
    ranks = torch.multiprocessing.start_processes(
        worker.run_rank, args=(WORLD, f"file://{root / 'store'}", spec_path, str(root)),
        nprocs=WORLD, join=False, start_method="spawn")
    mesh = make_mesh(device="cpu")
    worker.warm_cpu_log()
    one = {
        "batchnorm": worker.batchnorm(spec, mesh),
        "batchnorm_bf16": worker.batchnorm(spec, mesh, torch.bfloat16),
        "float64": worker.train_steps(spec, mesh, torch.float64),
        "float32": worker.train_steps(spec, mesh, torch.float32),
        "bfloat16": worker.train_steps(spec, mesh, torch.bfloat16),
        "validate": worker.validate(spec, str(root / "validate1")),
    }
    while not ranks.join():
        pass
    got = [torch.load(str(root / f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    yield spec, got, one
    shutil.rmtree(root, ignore_errors=True)


def test_collectives(world2):
    _, got, _ = world2
    for rank, out in enumerate(got):
        assert out["process_info"] == (rank, WORLD) and out["mesh"] == (WORLD, rank)
        np.testing.assert_array_equal(out["gathered"], np.repeat([0.0, 1.0], 2)[:, None]
                                      * np.ones((4, 3), np.float32))
        assert out["gathered"].dtype == np.float32
        np.testing.assert_array_equal(out["gathered_mask"], [1, 0, 0, 1, 1, 0])
        assert out["gathered_mask"].dtype == bool
        np.testing.assert_array_equal(out["broadcast"], np.float32([0.5, 0.0]))


def test_single_process_is_world_one(monkeypatch):
    """No group without opt-in; world-1 helpers are identities; JAX's
    errors for too many devices and an indivisible batch."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.maybe_initialize(device="cpu") is False
    assert distributed.process_info() == (0, 1) and distributed.is_primary()
    mesh = make_mesh(device="cpu")
    assert (mesh.world, mesh.rank, mesh.group) == (1, 0, None)
    x = np.arange(6.0).reshape(3, 2)
    np.testing.assert_array_equal(distributed.allgather_host(x), x)
    np.testing.assert_array_equal(distributed.broadcast_floats([1.5]), [1.5])
    batch = {"wav": x, "n_valid": np.int32(3)}
    assert set(distributed.make_global_batch(batch, mesh)) == {"wav"}
    with pytest.raises(ValueError, match="only 1 devices are visible"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="not divisible by the 2-device"):
        shard_batch(batch, dataclasses.replace(mesh, world=2))


def test_step_refuses_a_state_not_on_the_mesh():
    """A data-parallel step on a state whose BatchNorms were not put on the
    mesh's group (``replicate_state``) raises before any collective,
    rather than normalizing with this rank's statistics alone."""
    model = create_model("efficientnet", label_dim=N_CLASS, eff_b=0, head_num=1)
    state = create_train_state(model, lambda step: LR, device="cpu")
    mesh = dataclasses.replace(make_mesh(device="cpu"), world=2, group=object())
    step = build_train_step(PreprocessConfig(target_length=T), "BCE", mesh)
    with pytest.raises(ValueError, match="replicate_state"):
        step(state, {"wav": np.zeros((2, 8), np.float32)}, None)


STEM_STATS = ("effnet._bn0.running_mean", "effnet._bn0.running_var")


@pytest.mark.parametrize("dtype", ["float64", "float32", "float64_remat", "bfloat16"])
def test_train_step_on_two_ranks_matches_one_process(world2, dtype):
    """``float64_remat``: the ranks replay each MBConv block's forward in
    backward (``--remat``), so the synced BatchNorm's forward collective
    runs again inside backward; held to the one-process step without remat
    at the float64 bars."""
    _, got, one = world2
    ref, r0, r1 = one[dtype.removesuffix("_remat")], got[0][dtype], got[1][dtype]
    # the replicas stay equal: one all-reduce gives both ranks the same sums
    torch.testing.assert_close(r0["loss"], r1["loss"], rtol=0, atol=0)
    for k, v in r0["state"].items():
        torch.testing.assert_close(v, r1["state"][k], rtol=0, atol=0, msg=k)
    loss_diff = (r0["loss"] - ref["loss"]).abs().max().item()
    stats = list(ref["first_stats"])
    params = [k for k in ref["state"] if k not in stats]
    diff = torch.cat([(r0["state"][k] - ref["state"][k]).abs().flatten().double()
                      for k in params]).numpy()
    first, final = (max((r0[part][k] - ref[part][k]).abs().max().item() for k in stats)
                    for part in ("first_stats", "state"))
    print(f"{dtype}: loss {loss_diff:.3g}, parameters max {diff.max():.3g} mean "
          f"{diff.mean():.3g} p99 {np.percentile(diff, 99):.3g}, statistics after "
          f"step 1 {first:.3g}, after step 2 {final:.3g}")
    if dtype.startswith("float64"):
        assert loss_diff < 1e-10
        assert diff.max() < 1e-9 and first < 1e-9 and final < 1e-9
    elif dtype == "bfloat16":
        # bf16 rounding amplified through train-mode BatchNorms (see the
        # module docstring): twice the measured, and Adam's own bound on
        # two steps (each moves a parameter by at most lr on either side)
        assert loss_diff < 2e-2 and first < 5e-2
        assert diff.max() <= 4 * LR + 1e-6 and diff.mean() < 1e-3
        # the stem's statistics come before any synced bf16 output is carried
        # on: float32 statistics of the same bf16 values on both sides
        # (measured 1.0e-6; 1.7e-4 with statistics taken in bf16)
        stem = max((r0["first_stats"][k] - ref["first_stats"][k]).abs().max().item()
                   for k in STEM_STATS)
        print(f"bfloat16: the stem's statistics after step 1 {stem:.3g}")
        assert stem < 3e-6, stem
    else:
        assert loss_diff < 3e-4
        assert diff.max() < 3 * LR and diff.mean() < 1e-5 and np.percentile(diff, 99) < 1e-4
        # the statistics of the first step (the second step's are of
        # parameters that Adam has already parted by up to 2 lr)
        assert first < 1e-5


def test_synced_batchnorm_matches_the_layer_on_the_whole_batch(world2):
    _, got, one = world2
    ref, r = one["batchnorm"], [g["batchnorm"] for g in got]
    print("synced BatchNorm vs the layer on the whole batch:", {
        k: float((torch.cat([x[k] for x in r]) if k in ("y", "dx") else r[0][k] + r[1][k]
                  if k in ("dw", "db") else r[0][k]).sub(ref[k]).abs().max()) for k in ref})
    for k in ("y", "dx"):
        torch.testing.assert_close(torch.cat([x[k] for x in r]), ref[k], rtol=0, atol=1e-6,
                                   msg=k)
    for k in ("dw", "db"):  # each rank's sum; the step averages them
        torch.testing.assert_close(r[0][k] + r[1][k], ref[k], rtol=0, atol=sum_bar(ref[k]),
                                   msg=k)
    for k in ("running_mean", "running_var"):
        torch.testing.assert_close(r[0][k], r[1][k], rtol=0, atol=0, msg=k)
        torch.testing.assert_close(r[0][k], ref[k], rtol=0, atol=1e-6, msg=k)


def test_synced_batchnorm_in_bfloat16_matches_the_layer(world2):
    """A bf16 input (``--dtype bfloat16``): the synced layer takes the
    statistics and the backward sums in float32 and rounds the output and
    the input gradient once to bf16, as the one-process layer
    (``F.batch_norm``) does on the whole batch: the output and the input
    gradient equal to its (measured: bit for bit), the parameter gradients
    and the running statistics (float32) at the float32 bars above."""
    _, got, one = world2
    ref, r = one["batchnorm_bf16"], [g["batchnorm_bf16"] for g in got]
    for k in ("y", "dx"):
        both = torch.cat([x[k] for x in r])
        assert both.dtype == ref[k].dtype == torch.bfloat16, k
        torch.testing.assert_close(both, ref[k], rtol=0, atol=0, msg=k)
    for k in ("dw", "db"):
        torch.testing.assert_close(r[0][k] + r[1][k], ref[k], rtol=0, atol=sum_bar(ref[k]),
                                   msg=k)
    for k in ("running_mean", "running_var"):
        torch.testing.assert_close(r[0][k], r[1][k], rtol=0, atol=0, msg=k)
        torch.testing.assert_close(r[0][k], ref[k], rtol=0, atol=1e-6, msg=k)


def test_synced_batchnorm_matches_flax_under_gspmd(world2):
    """flax's BatchNorm on the batch sharded over a 2-device 'data' mesh
    (``build_train_step``'s path): its output, input and parameter
    gradients of sum(y * g) and running statistics."""
    spec, got, _ = world2
    r = [g["batchnorm"] for g in got]
    x = np.transpose(spec["bn_x"], (0, 2, 3, 1))  # NHWC
    g = np.transpose(spec["bn_g"], (0, 2, 3, 1))
    st = {k: v.numpy() for k, v in spec["bn_state"].items()}
    params = {"scale": st["weight"], "bias": st["bias"]}
    stats = {"mean": st["running_mean"], "var": st["running_var"]}
    bn = ReferenceBatchNorm(use_running_average=False, momentum=0.99, epsilon=BN_EPS)
    mesh = jax_make_mesh(2)

    def f(params, x):
        y, mutated = bn.apply({"params": params, "batch_stats": stats}, x,
                              mutable=["batch_stats"])
        return jnp.sum(y * g), (y, mutated["batch_stats"])

    data = NamedSharding(mesh, P("data"))
    (_, (y, new_stats)), (dparams, dx) = jax.jit(
        jax.value_and_grad(f, argnums=(0, 1), has_aux=True),
        in_shardings=(NamedSharding(mesh, P()), data))(params, jnp.asarray(x))

    x64 = x.astype(np.float64)
    mean, var = x64.mean((0, 1, 2)), x64.var((0, 1, 2))
    x_hat = (x64 - mean) / np.sqrt(var + BN_EPS)
    exact = {"y": x_hat * params["scale"] + params["bias"],
             "db": g.sum((0, 1, 2)), "dw": (g * x_hat).sum((0, 1, 2))}
    n = x64.size // x64.shape[-1]
    exact["dx"] = params["scale"] / np.sqrt(var + BN_EPS) / n * (
        n * g - exact["db"] - x_hat * exact["dw"])
    flax = {"y": np.asarray(y), "dx": np.asarray(dx), "dw": np.asarray(dparams["scale"]),
            "db": np.asarray(dparams["bias"])}
    def nhwc(t):
        return t.permute(0, 2, 3, 1).numpy()

    port = {"y": np.concatenate([nhwc(q["y"]) for q in r]),
            "dx": np.concatenate([nhwc(q["dx"]) for q in r]),
            "dw": (r[0]["dw"] + r[1]["dw"]).numpy(), "db": (r[0]["db"] + r[1]["db"]).numpy()}
    for k in port:
        bar = sum_bar(exact[k]) if k in ("dw", "db") else 1e-6
        flax_own = float(np.abs(flax[k] - exact[k]).max())
        print(f"{k}: port vs float64 {np.abs(port[k] - exact[k]).max():.3g}, vs flax "
              f"{np.abs(port[k] - flax[k]).max():.3g} (flax vs float64 {flax_own:.3g})")
        np.testing.assert_allclose(port[k], exact[k], atol=bar, rtol=0, err_msg=k)
        np.testing.assert_allclose(port[k], flax[k], atol=bar + flax_own, rtol=0, err_msg=k)
    np.testing.assert_allclose(r[0]["running_mean"].numpy(), np.asarray(new_stats["mean"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(r[0]["running_var"].numpy(), np.asarray(new_stats["var"]),
                               atol=1e-6, rtol=0)


def test_eval_gather_returns_the_one_process_rows(world2):
    """11 val clips at global batch 4: each rank's strided shard ends in a
    padded batch; the gathered rows are the one-process rows in order."""
    _, got, one = world2
    ref = one["validate"]
    assert ref["pred"].shape == (11, N_CLASS) and "pred" not in got[1]["validate"]
    print(f"eval gather: predictions {np.abs(got[0]['validate']['pred'] - ref['pred']).max():.3g},"
          f" mAP {abs(got[0]['validate']['mAP'] - ref['mAP']):.3g}, loss "
          f"{abs(got[0]['validate']['loss'] - ref['loss']):.3g}")
    np.testing.assert_allclose(got[0]["validate"]["pred"], ref["pred"], atol=1e-5, rtol=0)
    for out in got:
        assert abs(out["validate"]["mAP"] - ref["mAP"]) < 1e-6
        assert abs(out["validate"]["loss"] - ref["loss"]) < 1e-6


def test_cli_run_on_two_ranks_writes_on_rank0_only(world2):
    """``cli.run`` under a group started beforehand (a launcher's path), in
    bfloat16 with q8save: it trains, validates and weight-averages; rank 0
    writes every file, rank 1 none, both return the same summary, and the
    checkpoints stay float32."""
    spec, got, _ = world2
    exp = spec["cli_dir"]
    assert got[1]["cli"]["written"] == []
    written = set(got[0]["cli"]["written"])
    for name in ("config.json", "result.csv", "progress.json", "wa_result.csv",
                 os.path.join("predictions", "target.csv"),
                 os.path.join("predictions", "predictions_1.csv"),
                 os.path.join("models", "epoch_1", CHECKPOINT_FILE + ".tmp"),
                 os.path.join("models", "wa", CHECKPOINT_FILE + ".tmp")):
        assert name in written, (name, sorted(written))
    assert got[0]["cli"]["summary"] == got[1]["cli"]["summary"]
    result = np.loadtxt(os.path.join(exp, "result.csv"), delimiter=",")
    assert result.shape == (10,) and np.all(np.isfinite(result))
    ckpt = torch.load(os.path.join(exp, "models", "epoch_1", CHECKPOINT_FILE),
                      weights_only=True)
    assert ckpt["step"] == 2  # 11 clips: 5 a rank, 2 a rank a batch
    assert all(t.dtype == torch.float32 for t in ckpt["model"].values())
    with open(os.path.join(exp, "config.json")) as f:
        cfg = json.load(f)
    assert (cfg["dtype"], cfg["act_compress"]) == ("bfloat16", "q8save")


def test_spawned_train_run(tmp_path, monkeypatch):
    """``psla-torch-train --num-devices 2 --device cpu``: two spawned gloo
    ranks train an epoch; the parent returns rank 0's summary. The ranks
    share the test process's 2 threads (``cli._rank_main``)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    datafile, label_csv = build_corpus(str(tmp_path / "corpus"), num_classes=N_CLASS,
                                       clips_per_class=2, seconds=0.5)
    exp = str(tmp_path / "exp")
    summary = cli.run(cli_argv(datafile, label_csv, exp, "--num-devices", "2"))
    assert set(summary) == {"best_single", "wa", "ensemble"}
    assert np.loadtxt(os.path.join(exp, "result.csv"), delimiter=",").shape == (10,)
    assert torch.load(os.path.join(exp, "models", "epoch_1", CHECKPOINT_FILE),
                      weights_only=True)["step"] == 8 // B


def test_serving_on_two_devices_matches_one(monkeypatch):
    config = PreprocessConfig(target_length=T)
    model = create_model("efficientnet", label_dim=N_CLASS, eff_b=0, head_num=HEADS)
    model.load_state_dict(from_jax_variables(jax_variables(HEADS, 21, N_CLASS), N_CLASS))
    names = {i: str(i) for i in range(N_CLASS)}
    one = InferenceEngine(model, config, names, batch_size=4, device="cpu")
    two = InferenceEngine(model, config, names, batch_size=4, num_devices=2, device="cpu")
    try:
        assert len(two.replicas) == 2 and two.replicas[0][0] is not two.replicas[1][0]
        batch = tone_batch(70, config.fbank.buffer_length(T))
        for rows in (4, 3):  # a full micro-batch, and one the batcher cut short
            args = (batch["wav"][:rows], batch["wav_mean"][:rows], batch["length"][:rows])
            got, want = two.batch_probs(*args), one.batch_probs(*args)
            print(f"serving on two devices, {rows} rows: {np.abs(got - want).max():.3g}")
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    finally:
        one.close()
        two.close()
    with pytest.raises(ValueError, match="not divisible"):
        InferenceEngine(model, config, names, batch_size=6, num_devices=4, device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 devices are visible"):
        InferenceEngine(model, config, names, batch_size=4, num_devices=2, device="cuda")
