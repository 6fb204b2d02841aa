"""Multi-seed ensembles across ranks (``--ensemble-seeds E`` on W ranks:
``parallel/mesh.make_mesh(ensemble=...)``, ``parallel/ensemble.py``,
``train/ensemble_loop.EnsembleTrainer``, ``cli.make_loaders`` and
``tools/ensemble --num-devices``) on the CPU.

Two gloo worlds a module, of 2 and 4 ranks (spawned processes meeting at
file stores under the module's tmp dir), run their checks once in
``tests/torch_ensemble_ranks_worker.py``, and each test reads its part.
The references are the same functions in this process at world 1: the
one-process ``EnsembleTrainer``, whose step tests/test_torch_ensemble.py
holds to the JAX package's.

Layouts (E seeds on W ranks, ``ensemble_layout``'s rows of R ranks): E=3
on W=2, one row of 2 ranks, every member on both, trained data-parallel;
E=2 on W=2, two rows of one rank and one member, each on the whole batch;
E=4 on W=2, two members a rank; E=2 on W=4, two rows of 2 ranks, each row
on its own process subgroup. Size: B0, 4 heads, 4 classes, T=64, global
batch 4, 2 steps with mixup, SpecAugment and drop-connect, in float64
(parameters too), from ``init_state``: a full model file
(tests/torch_port_fixtures.py's variables) overlaid on each member's own
initialisation from seed i, the heads kept per seed; validation
on 7 clips, so a rank's last batch is padded where a row has 2 ranks.

Bars, tests/test_torch_distributed.py's float64 ones: a step on several
ranks is the one-process step up to the order of its sums, so the loss and
the seed losses within 1e-10, the parameters and running statistics
within 1e-9 after each step, and the validation's predictions, mAP and
loss within 1e-9 (the mAP the same on every rank); the replicas of a
member in a row bit for bit. The CLI
(float32, E=2 on W=2, one member a rank on the whole batch) computes what
one process computes: its checkpoints are held to the one-process run's
within 1e-9 whatever the run was resumed from. ``tools/ensemble`` on 2
ranks: the one-process predictions within 1e-5 (tests/test_serve.py:197).

E=2 on W=4 is also held to the JAX package's sharded ensemble step
(``build_ensemble_train_step_single_rng`` on an ('ensemble', 'data') mesh
of 2 x 2 of the 8 virtual CPU devices), as tests/test_torch_ensemble.py
holds the one-process step: float32, drop-connect off, each member from
its seed's shared numpy-made variables and given the draws JAX derives
for its global index, 2 steps; each seed's loss within 1e-4 on the first
step and 2e-2 over the run (tests/test_torch_twin.py's bars). JAX's fbank
computes in float32 (``psla_tpu/frontend/fbank.py``), so the float64 bars
do not apply to this comparison.
"""

import concurrent.futures

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch
import torch.multiprocessing

import jax

from psla_tpu.frontend.pipeline import PreprocessConfig as JaxPreprocessConfig
from psla_tpu.parallel import ensemble as jax_ensemble
from psla_tpu.parallel.ensemble import ensemble_layout as jax_ensemble_layout
from psla_tpu.parallel.mesh import make_mesh as jax_make_mesh
from psla_tpu.parallel.mesh import shard_batch as jax_shard_batch
from psla_tpu.train.optim import make_optimizer as jax_make_optimizer
from psla_tpu_torch import cli
from psla_tpu_torch.config import ExperimentConfig
from psla_tpu_torch.models.convert import CHECKPOINT_FILE, from_jax_variables
from psla_tpu_torch.parallel import mesh as port_mesh
from psla_tpu_torch.parallel.ensemble import ensemble_layout
from psla_tpu_torch.tools import ensemble as ensemble_tool
from psla_tpu_torch.train.step import TrainDraws
from tests import test_torch_ensemble as one_rank
from tests import torch_ensemble_ranks_worker as worker
from tests.synth import build_corpus
from tests.test_torch_augment import jax_preprocess_draws, tone_batch
from tests.torch_port_fixtures import jax_variables

torch.set_num_threads(2)

T, B, N_CLASS, HEADS = 64, 4, 4, 4
LAYOUTS = [(3, 2), (2, 2), (4, 2), (2, 4)]
JAX_RNG = 42  # the base key of the JAX-held steps


def _held(n: int) -> dict:
    """The JAX-held E=2 steps' inputs (tests/test_torch_ensemble.py's):
    each seed's state_dict, two batches, and for each step every member's
    draws as JAX's step derives them, ``split(fold_in(fold_in(rng, m),
    step))[0]`` for global member m."""
    rng = jax.random.PRNGKey(JAX_RNG)
    batches = one_rank.batches(n)
    f = ExperimentConfig(target_length=T).preprocess_config().fbank.num_mel_bins
    return {
        "heads": one_rank.HEADS, "lr": one_rank.LR, "aug": one_rank.AUG, "batches": batches,
        "state_dicts": [from_jax_variables(jax_variables(one_rank.HEADS, s, N_CLASS), N_CLASS)
                        for s in one_rank.SEEDS],
        "draws": [[TrainDraws(jax_preprocess_draws(jax.random.split(jax.random.fold_in(
            jax.random.fold_in(rng, m), i))[0], B, T, f), None) for m in range(2)]
            for i in range(len(batches))],
    }


def _jax_side(n: int, held_path: str) -> dict:
    """Run in a thread while the ranks train: the held steps' inputs
    (``_held``), written to ``held_path`` for the 4-rank world, then JAX's
    sharded step compiled and run on them: its losses."""
    held = _held(n)
    torch.save(held, held_path + ".tmp")
    os.replace(held_path + ".tmp", held_path)
    return _jax_rows_losses(_jax_rows_step(held["batches"][0]), held)


def _jax_rows_step(batch: dict):
    """JAX's sharded E=2 train step on an ('ensemble', 'data') mesh of 2 x 2
    virtual CPU devices, compiled: (step, mesh, optimizer)."""
    mesh = jax_make_mesh(num_devices=4, ensemble=2)
    tx = jax_make_optimizer(lambda step: one_rank.LR)
    cfg = JaxPreprocessConfig(target_length=T, **one_rank.AUG)
    state = one_rank.jax_train_state(
        [jax_variables(one_rank.HEADS, s, N_CLASS) for s in one_rank.SEEDS], tx, mesh)
    # LLVM's expensive passes keep IEEE semantics: the same bits, compiled faster
    step = jax_ensemble.build_ensemble_train_step_single_rng(
        one_rank.jax_model(), tx, cfg, "BCE", mesh, 2).lower(
        state, jax_shard_batch(batch, mesh), jax.random.PRNGKey(JAX_RNG)).compile(
        {"xla_llvm_disable_expensive_passes": True})
    return step, mesh, tx


def _jax_rows_losses(compiled_step, held: dict) -> dict:
    step, mesh, tx = compiled_step
    state = one_rank.jax_train_state(
        [jax_variables(one_rank.HEADS, s, N_CLASS) for s in one_rank.SEEDS], tx, mesh)
    losses, seed_losses = [], []
    for batch in held["batches"]:
        state, m = step(state, jax_shard_batch(batch, mesh), jax.random.PRNGKey(JAX_RNG))
        losses.append(float(m["loss"]))
        seed_losses.append(np.asarray(m["seed_loss"]))
    return {"loss": np.array(losses), "seed_loss": np.stack(seed_losses)}


def _spec(root) -> dict:
    """Everything the ranks read: the batches, the trainer's settings, the
    corpus (8 tone clips; the val set its first 7), the CLI's directories
    and the ensemble tool's arguments."""
    n = ExperimentConfig(target_length=T).preprocess_config().fbank.buffer_length(T)
    batches = []
    for seed in range(2):
        batch = tone_batch(80 + seed, n)
        batch["labels"] = np.eye(N_CLASS, dtype=np.float32)[(np.arange(B) + seed) % N_CLASS]
        batch["mix_labels"] = np.roll(batch["labels"], 1, 0)
        batches.append(batch)
    datafile, label_csv = build_corpus(str(root / "corpus"), num_classes=N_CLASS,
                                       clips_per_class=2, seconds=0.5)
    with open(datafile) as f:
        entries = json.load(f)["data"]
    val_file = str(root / "val.json")
    with open(val_file, "w") as f:
        json.dump({"data": entries[:7]}, f)
    one_best = [str(root / "one_epoch1" / "models" / f"best_seed{i}") for i in range(2)]
    # the members' backbone: the shared numpy-made variables (conv kernels
    # over fan-in, so that the eval forward depends on its input)
    backbone = str(root / "backbone.pth")
    torch.save(from_jax_variables(jax_variables(HEADS, 31, N_CLASS), N_CLASS), backbone)
    return {
        "T": T, "n_class": N_CLASS, "batches": batches, "held_path": str(root / "held.pt"),
        "trainer_config": dict(
            data_train=datafile, data_val=val_file, label_csv=label_csv, n_class=N_CLASS,
            eff_b=0, att_head=HEADS, target_length=T, batch_size=B, num_workers=1,
            impretrain=False, freqm=48, timem=24, mixup=0.5, lr=1e-3, warmup=False,
            pretrained_ckpt=backbone),
        "corpus": (datafile, val_file, label_csv),
        "cli_dir": str(root / "cli_ranks"),
        "cli_copies": {"one_epoch1": str(root / "one_epoch1_resumed_on_ranks"),
                       "ranks_epoch1": str(root / "ranks_epoch1")},
        "tool_argv": tool_argv(one_best, datafile, label_csv, str(root / "tool_ranks"),
                               "--num-devices", "2"),
    }


def tool_argv(checkpoints, datafile, label_csv, out_dir, *extra) -> list[str]:
    return [*checkpoints, "--data-eval", datafile, "--label-csv", label_csv, "--eff_b", "0",
            "--n_class", str(N_CLASS), "--target_length", str(T), "--batch-size", "4",
            "--out-dir", out_dir, "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The spec, each world's ranks' results, and the one-process
    references and JAX's (computed here while the ranks run); the files are
    removed after the module's tests."""
    root = tmp_path_factory.mktemp("ensemble_ranks")
    n = ExperimentConfig(target_length=T).preprocess_config().fbank.buffer_length(T)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    jax_side = pool.submit(_jax_side, n, str(root / "held.pt"))
    spec = _spec(root)
    spec_path = str(root / "spec.pt")
    torch.save(spec, spec_path)
    ranks = [torch.multiprocessing.start_processes(
        worker.run_rank, args=(w, f"file://{root / f'store{w}'}", spec_path, str(root)),
        nprocs=w, join=False, start_method="spawn") for w in (2, 4)]
    # the one-process first epoch: the ranks resume a copy (once its DONE
    # file is there), and the tool evaluates its best members. The CLI runs
    # here take one thread, as a rank does: in float32 other threads give
    # other bits, which Adam turns into steps of lr where a gradient is near 0
    torch.set_num_threads(1)
    try:
        cli.run(worker.cli_argv(spec, str(root / "one_epoch1"), 1))
        shutil.copytree(root / "one_epoch1", spec["cli_copies"]["one_epoch1"])
    finally:  # the ranks go on (and fail) rather than wait
        os.makedirs(spec["cli_copies"]["one_epoch1"], exist_ok=True)
        open(os.path.join(spec["cli_copies"]["one_epoch1"], "DONE"), "w").close()
    cli.run(worker.cli_argv(spec, str(root / "one_epochs2"), 2))
    torch.set_num_threads(2)
    worker.warm_cpu_log()
    one = {e: worker.ensemble_steps(spec, e, str(root / f"steps_e{e}_w1")) for e in (3, 2, 4)}
    one["tool"] = ensemble_tool.run(tool_argv(spec["tool_argv"][:2], *spec["corpus"][::2],
                                              str(root / "tool_one")))
    for group in ranks:
        while not group.join():
            pass
    got = {w: [torch.load(str(root / f"world{w}_rank{r}.pt"), weights_only=False)
               for r in range(w)] for w in (2, 4)}
    # the ranks' first epoch, resumed in one process (a copy: the test reads
    # the first epoch's files)
    resumed = str(root / "ranks_epoch1_resumed")
    shutil.copytree(spec["cli_copies"]["ranks_epoch1"], resumed)
    torch.set_num_threads(1)
    cli.run(worker.cli_argv(spec, resumed, 2, "--resume"))
    torch.set_num_threads(2)
    one["jax"] = jax_side.result()
    pool.shutdown()
    yield spec, got, one, root
    shutil.rmtree(root, ignore_errors=True)


def _max_diff(a: dict, b: dict) -> float:
    assert a.keys() == b.keys()
    return max(float((a[k] - b[k]).abs().max()) for k in a)


@pytest.mark.parametrize("seeds,world", LAYOUTS, ids=[f"E{e}-W{w}" for e, w in LAYOUTS])
def test_layout_steps_match_one_process(worlds, seeds, world):
    _, got, one = worlds[:3]
    ref, ranks = one[seeds], [g[seeds] for g in got[world]]
    rows, _, per_row = ensemble_layout(seeds, world, 0, world)
    for rank, r in enumerate(ranks):
        row, e_local = rank // per_row, seeds // rows
        assert r["row"] == row
        assert r["members"] == list(range(row * e_local, (row + 1) * e_local))
        # every rank holds the whole ensemble's losses and stacked members
        torch.testing.assert_close(r["loss"], ranks[0]["loss"], rtol=0, atol=0)
        for step in range(2):
            for k, v in r["stacked"][step].items():
                torch.testing.assert_close(v, ranks[0]["stacked"][step][k], rtol=0, atol=0)
    # the replicas of a member in a row are equal
    for rank in range(world):
        first = rank - rank % per_row
        for a, b in zip(ranks[rank]["local"], ranks[first]["local"]):
            for k in a:
                torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
    loss = float((ranks[0]["loss"] - ref["loss"]).abs().max())
    seed_loss = float((ranks[0]["seed_loss"] - ref["seed_loss"]).abs().max())
    states = [_max_diff(ranks[0]["stacked"][s], ref["stacked"][s]) for s in range(2)]
    print(f"E={seeds} on W={world}: loss {loss:.3g}, seed losses {seed_loss:.3g}, "
          f"parameters and statistics after each step {states[0]:.3g} {states[1]:.3g}")
    assert ref["seed_loss"].shape == (2, seeds)
    torch.testing.assert_close(ref["loss"], ref["seed_loss"].mean(1), rtol=0, atol=0)
    assert loss < 1e-10 and seed_loss < 1e-10
    assert max(states) < 1e-9
    # the members are apart: each keeps the head of its own seed
    w = next(k for k, v in ref["stacked"][1].items() if k.startswith("attention.") and v.dim() > 2)
    assert float((ref["stacked"][1][w][0] - ref["stacked"][1][w][1]).abs().max()) > 1e-3


def test_rows_of_ranks_match_the_jax_sharded_step(worlds):
    """E=2 on two rows of 2 ranks against JAX's step on the 2 x 2 mesh: every
    seed's loss, and the loss as the mean over both seeds, on every rank."""
    _, got, one = worlds[:3]
    want = one["jax"]
    for rank, g in enumerate(got[4]):
        seed_loss, loss = g["held"]["seed_loss"].numpy(), g["held"]["loss"].numpy()
        assert seed_loss.shape == want["seed_loss"].shape == (2, 2)
        np.testing.assert_array_equal(loss, seed_loss.mean(1).astype(loss.dtype))
        diffs = np.abs(seed_loss - want["seed_loss"])
        print(f"rank {rank}: seed losses {seed_loss.tolist()} vs JAX's "
              f"{want['seed_loss'].tolist()}: first step {diffs[0].max():.3g}, run "
              f"{diffs.max():.3g}; mean {np.abs(loss - want['loss']).max():.3g}")
        assert diffs[0].max() < 1e-4 and diffs.max() < 2e-2
        assert np.abs(loss - want["loss"])[0] < 1e-4 and np.abs(loss - want["loss"]).max() < 2e-2
    # the seeds differ by more than the first step's bar, so it sees their order
    assert np.abs(want["seed_loss"][0, 0] - want["seed_loss"][0, 1]) > 1e-4


@pytest.mark.parametrize("seeds,world", LAYOUTS, ids=[f"E{e}-W{w}" for e, w in LAYOUTS])
def test_layout_validation_matches_one_process(worlds, seeds, world):
    """Every member's predictions on the 7 val clips, gathered in the
    dataset's order (rank 0 writes them; no other rank has them)."""
    _, got, one = worlds[:3]
    ref, ranks = one[seeds], [g[seeds] for g in got[world]]
    assert ref["pred"].shape == (seeds, 7, N_CLASS)
    assert all("pred" not in r for r in ranks[1:])
    diff = float(np.abs(ranks[0]["pred"] - ref["pred"]).max())
    print(f"E={seeds} on W={world}: validation predictions {diff:.3g}")
    assert diff < 1e-9
    np.testing.assert_allclose(ranks[0]["mean_pred"], ref["mean_pred"], atol=1e-9, rtol=0)
    # the clips' predictions differ by far more than the bar, so the bar
    # sees the rows' order
    assert np.ptp(ref["pred"], axis=1).min() > 1e-5
    for r in ranks:
        assert r["val_mAP"] == ranks[0]["val_mAP"]
        assert abs(r["val_mAP"] - ref["val_mAP"]) < 1e-9
        assert abs(r["val_loss"] - ref["val_loss"]) < 1e-9


def test_cli_on_two_ranks_writes_on_rank0_only(worlds):
    spec, got, _ = worlds[:3]
    first = [g["cli"]["first"] for g in got[2]]
    assert first[1]["written"] == []
    written = set(first[0]["written"])
    for name in ("config.json", "result.csv", "seed_result.csv.tmp", "progress.json",
                 os.path.join("predictions", "target.csv"),
                 os.path.join("predictions", "predictions_1_seed1.csv"),
                 os.path.join("models", "epoch_1", CHECKPOINT_FILE + ".tmp"),
                 os.path.join("models", "best_seed1", CHECKPOINT_FILE + ".tmp"),
                 os.path.join("models", "wa_seed1", CHECKPOINT_FILE + ".tmp")):
        assert name in written, (name, sorted(written))
    assert first[0]["summary"] == first[1]["summary"]
    for part in ("resumed", "from_one_process", "tool"):
        assert got[2][0]["cli"][part] == got[2][1]["cli"][part], part


def _ckpt(exp_dir: str, tag: str) -> dict:
    return torch.load(os.path.join(exp_dir, "models", tag, CHECKPOINT_FILE),
                      map_location="cpu", weights_only=True)


def _checkpoints_agree(a: dict, b: dict, what: str):
    assert a["step"] == b["step"] and a.get("seeds") == b.get("seeds") == 2, what
    diff = _max_diff(a["model"], b["model"])
    for sa, sb in zip(a["optimizer"], b["optimizer"]):
        for i, moments in sa["state"].items():
            diff = max(diff, _max_diff(moments, sb["state"][i]))
    print(f"{what}: {diff:.3g}")
    assert diff < 1e-9, what


def test_cli_checkpoint_is_the_one_process_one(worlds):
    """The first epoch's stacked checkpoint and each member's extract, as
    two ranks wrote them, against one process's."""
    spec, _, _, root = worlds
    ranks, one = spec["cli_copies"]["ranks_epoch1"], str(root / "one_epoch1")
    for tag in ("epoch_1", "wa"):
        _checkpoints_agree(_ckpt(ranks, tag), _ckpt(one, tag), f"{tag} on 2 ranks vs 1")
    for i in range(2):
        a, b = _ckpt(ranks, f"best_seed{i}"), _ckpt(one, f"best_seed{i}")
        assert "seeds" not in a and _max_diff(a["model"], b["model"]) < 1e-9


@pytest.mark.parametrize("resumed", ["ranks_from_ranks", "ranks_from_one_process",
                                     "one_process_from_ranks"])
def test_cli_resume_reproduces_the_uninterrupted_run(worlds, resumed):
    """The first epoch resumed to the second: on 2 ranks from the ranks'
    own checkpoint, on 2 ranks from one process's, and in one process from
    the ranks'; each against one process's uninterrupted 2 epochs."""
    spec, _, _, root = worlds
    exp = {"ranks_from_ranks": spec["cli_dir"],
           "ranks_from_one_process": spec["cli_copies"]["one_epoch1"],
           "one_process_from_ranks": str(root / "ranks_epoch1_resumed")}[resumed]
    for tag in ("epoch_2", "wa"):
        _checkpoints_agree(_ckpt(exp, tag), _ckpt(str(root / "one_epochs2"), tag),
                           f"{resumed} {tag}")
    np.testing.assert_allclose(np.loadtxt(os.path.join(exp, "result.csv"), delimiter=","),
                               np.loadtxt(os.path.join(root, "one_epochs2", "result.csv"),
                                          delimiter=","), atol=1e-6, rtol=0)


def test_ensemble_tool_on_two_ranks_matches_one_process(worlds):
    spec, got, one, root = worlds
    for name in ("target.csv", "predictions_0.csv", "predictions_1.csv"):
        a, b = (np.loadtxt(os.path.join(root, d, name), delimiter=",")
                for d in ("tool_ranks", "tool_one"))
        assert a.shape == b.shape == (8, N_CLASS), name
        print(f"tools/ensemble on 2 ranks, {name}: {np.abs(a - b).max():.3g}")
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=name)
    ranks = got[2][0]["cli"]["tool"]
    assert abs(ranks["ensemble"]["mAP"] - one["tool"]["ensemble"]["mAP"]) < 1e-5


@pytest.mark.parametrize("world", [2, 3, 4, 8])
def test_layout_and_loader_remap_match_jax(world, monkeypatch):
    """For 1-12 seeds on ``world`` ranks (a card each), every rank's row
    and position against the JAX mesh's device grid
    (``devices.reshape(ensemble, n / ensemble)``), and the shard and batch
    of its loaders (``cli.make_loaders``) against the JAX CLI's remap."""
    devices = np.arange(world)
    monkeypatch.setattr(port_mesh.dist, "is_available", lambda: True)
    monkeypatch.setattr(port_mesh.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(port_mesh.dist, "get_world_size", lambda group=None: world)
    monkeypatch.setattr(port_mesh.dist, "new_group", lambda ranks: tuple(ranks))
    shards = []
    monkeypatch.setattr(cli, "AudioLoader", lambda df, config, **kw: shards.append(config))
    monkeypatch.setattr(cli, "load_datafile", lambda *a: None)
    for seeds in range(1, 13):
        rows = jax_ensemble_layout(seeds, world, 0, world)[0]
        grid = np.asarray(jax_make_mesh(devices=devices, ensemble=rows,
                                        ensemble_axis=True).devices)
        for rank in range(world):
            assert ensemble_layout(seeds, world, rank, world) == \
                jax_ensemble_layout(seeds, world, rank, world)
            monkeypatch.setattr(port_mesh.dist, "get_rank", lambda group=None: rank)
            m = port_mesh.make_mesh(device="cpu", ensemble=rows)
            (row,), (pos,) = np.nonzero(grid == rank)
            assert (m.rows, m.row, m.world, m.rank) == (rows, row, grid.shape[1], pos)
            assert m.group == (None if m.world == 1 else (
                port_mesh.dist.group.WORLD if rows == 1 else
                tuple(range(row * m.world, (row + 1) * m.world))))
            monkeypatch.setattr(cli, "process_info", lambda: (rank, world))
            cfg = ExperimentConfig(ensemble_seeds=seeds, batch_size=24, bal=False,
                                   data_eval="eval.json")
            shards.clear()
            cli.make_loaders(cfg)
            _, host, hosts = (jax_ensemble_layout(seeds, world, rank, world) if seeds > 1
                              else (1, rank, world))
            assert [(c.host_id, c.num_hosts) for c in shards] == [(host, hosts)] * 3
            assert [c.batch_size for c in shards] == [24 // hosts] * 2 + [48 // hosts]
    # one row of every rank (gcd(W + 1, W) = 1): a batch of 5 does not split
    cfg = dataclasses.replace(cfg, ensemble_seeds=world + 1, batch_size=5)
    with pytest.raises(ValueError, match=f"the {world} ranks of an ensemble row"):
        cli.make_loaders(cfg)


def test_trainer_refuses_loaders_sharded_by_global_rank(worlds):
    """On 4 ranks, E=2: loaders sharded by the global rank (r of 4) rather
    than the position within the row (r % 2 of 2) raise on every rank."""
    _, got, _ = worlds[:3]
    for rank, g in enumerate(got[4]):
        assert f"is sharded as {rank}/4" in g["refused"] and f"{rank % 2}/2" in g["refused"]
