"""Drive the PyTorch port's paths once on an NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py [--profile]

or on N cards, for the phases that span them (12 and 14 (c)):

    python3 chip_smoke.py --data-parallel N [--profile]

Phases, in order (any failure ends the script with a non-zero exit and no
result line):

1. Header: the card's name and power limit (nvidia-smi), torch and CUDA.
2. Build: every hand-written kernel library, compiled from the sources in
   this checkout (one nvcc each, in parallel).
3. The fbank kernel versus its plain version (the 'fft64' lowering) and
   the float32 'fft' and 'gemm' lowerings at the serving shape ([16, 169200]
   waveforms, 1056 frames): ragged lengths (full, short, zero, longer than
   the buffer) of noise plus tones with a silent tail, for every fbank
   precision. Prints the kernel's, the plain version's and the library
   yardsticks' times (CUDA events) beside the kernel's bound, and fails if
   the kernel is not below cuBLAS's frames @ A; then the kernel at
   bench.py's training batch (128 full clips) beside its bound.
4. Serving at full width: EffNet-B2, 4 heads, 527 classes, T=1056,
   micro-batch 16, float32, a 2-member ensemble of seeded random weights
   (BatchNorm statistics drawn with numpy so the outputs are not flat).
   Concurrent /predict requests (PCM16 WAV, JSON, a 44.1 kHz WAV, a 25 s
   clip, a malformed body) through ``make_server``; the launch counts are
   set to 0 just before and read just after. The answers are checked
   against the plain fbank path on the same members, then the clips/s of
   full 16-clip dispatches are timed in float32 and bfloat16. The engines
   run serving copies (``models.layers.for_inference``: weights held in
   the dtype they compute in, BatchNorm folded): the bf16 dispatch is held
   to the per-call bf16 modules on the same log-mel (expected bit-equal, at
   1e-4), one fbank launch (counted), and each side's dtype casts in one
   dispatch are counted (the engine's of weights must be 0).
   ``--profile`` adds a torch.profiler table of one dispatch in each dtype,
   with its ``copy_`` and ``_to_copy`` counts.
5. The fused MBConv kernels at full width: the first seeded B2 member's
   eval forward on a 16-clip log-mel batch from the fbank kernel, with
   each of the 23 blocks' input and output captured. One sweep through
   ``ops.fused_mbconv_eval_v2`` (all 23 blocks) and ``ops.fused_mbconv_eval``
   (the 19 stride-1 blocks), float32, is the path whose launches are
   counted and checked against the module blocks. Then each kernel against
   its plain version for fast=False and fast=True (v1 at tiles 2048 and
   256; each kernel twice, for the same bits), and per-block times (CUDA
   events) of each kernel, its plain version and the module block beside
   the block's bound, with the grids of passes 1 and 2 (blocks of threads,
   slices S, window pixels P); v2's four phase kernels (A expand, B
   depthwise, C squeeze-excite, D project) are also timed alone, per block
   and summed over the sweep, for fast=False and fast=True.
6. Training at full width: the audioset_full train step (EffNet-B2, 4
   heads, 527 classes, T=1056, batch 100, float32 with TF32 off; mixup
   0.5, SpecAugment 48/192, drop-connect 0.2; Adam on the PSLA schedule
   with the step counter past warmup) on seeded weights and an int16 batch
   of ragged tone clips. One step through the fbank kernel (its launch
   count set to 0 just before and read just after: one launch) is held to
   the same step, with the same draws, through the plain fbank ('fft64'):
   loss, running statistics and parameters; then remat=True from the same
   start. 2 warm-up and 10 timed steps: device ms (CUDA events), wall ms,
   clips/s, peak memory; the fbank kernel on the step's waveforms beside
   its bound, its plain version and the library yardsticks, and its share
   of a step. ``--profile`` adds a torch.profiler table of one step and its
   device time by group.
7. The trainer end to end: ``psla-torch-train``'s entry point
   (``cli.run``) at the audioset_full preset (B2, 4 heads, 527 classes,
   T=1056, batch 100, float32, mixup, SpecAugment, balanced sampling, the
   int16 wire, pinned prefetch 2 batches ahead) on a seeded corpus of tone
   clips written here (300 train and 100 val clips of 10 s, 1-3 classes
   each, with their balanced-sampling weights), cut to 2 epochs from a
   fresh initialisation without warmup: the loader's decode rate alone,
   then train, validate, checkpoints, weight averaging over epochs 1-2 and
   the protocol with the val list as the eval set. The fbank kernel's
   launches (set to 0 just before, read just after) must equal the train
   steps plus every eval batch, and those from the start of epoch 2 to the
   end of its validation its steps plus its val batches; the kernel is held
   to its plain version on the protocol's first eval batch (twice the train
   batch, its padded tail included); result.csv, the prediction CSVs and the
   checkpoints must exist and be finite; the wa checkpoint must serve
   through ``InferenceEngine``. Then the same command for 1 epoch and
   again for 2 with ``--resume``: the sampled indices and the steps' draws
   must equal the uninterrupted run's, and the epoch-2 losses be within
   2e-2. Prints the trainer's clips/s beside phase 6's bare step, the
   meters, the decode rate and peak memory; ``--profile`` adds the card's
   idle share over epoch 2's steps and where the copies to the card ran.

8. The eval side at full width (B2, 4 heads, 527 classes, T=1056,
   float32) on phase 7's corpus writer: 100 tone clips of 10 s, eval batch
   32 (4 batches, the last padded), 3 seeded members saved as ``.pth``
   (one with ``module.`` prefixes and an ``_fc``). ``tools/ensemble.main``
   stacked and ``--sequential``, in turns (stacked, sequential,
   sequential, stacked): the fbank launches of each run (set to 0 just
   before, read just after) must be the eval batches, and E times them;
   the predictions within 1e-5 of each other, ``target.csv`` in datafile
   order; then the two passes alone on models already on the card.
   ``weight_average_eval``: the averaged state within 1e-6 of the float64
   mean, a finite mAP. ``compute_norm_stats`` through the kernel within
   2e-4 of the same through the plain fbank. ``psla-torch-predict`` on a
   60 s clip within 1e-4 of ``predict_long`` with the plain fbank.
   ``psla-torch-export`` of 2 members at its bf16 default and with
   ``--dtype float32``, both loaded and run at batch 16 by one subprocess
   that imports torch alone (no module of this repo, no CPU device literal
   or tensor left in the moved programs): the bf16 artifact within 1e-6 of
   the live bf16 program it was traced from ('gemm' fbank), its distance
   from the live bf16 engine (fbank kernel) printed; the float32 artifact
   within 1e-4 of ``InferenceEngine.batch_probs`` through the kernel; each
   artifact and each live engine timed a call, the sizes printed. Then
   ``python -m psla_tpu_torch.tools.export_chipcheck`` at its defaults (B2,
   527 classes, T=1056, batch 4, bf16) in a subprocess: its JSON line
   must say ``"ok": true``.
   ``Trainer.init_state`` under ``impretrain`` from a seeded
   ImageNet-layout B2 file named by ``PSLA_TPU_IMAGENET_CKPT``: the stem
   is the RGB sum. ``--profile`` adds the device time by kernel of one
   call of each artifact and each live engine.
9. The FSD50K recipe and the tools on the card (the fsd50k preset: B2, 4
   heads, 200 classes, T=3000, batch 24, float32 with TF32 off; mixup 0.5,
   SpecAugment 48/192). (a) ``prep_fsd`` on a seeded FSD50K-layout root
   (the ground-truth CSVs and 96 dev plus 48 eval clips of 0.3-30 s at
   44.1 kHz): the native resampler must take every file, three of its
   outputs within 1 PCM16 step of ``wav.resample``, the datafiles the
   CSVs' rows and the weight file the sampler's weights. (b) The fbank
   kernel on the first eval batch ([24, 480240] with the clips' ragged
   lengths -> 3000 frames): one launch, counted, within 2e-4 of its plain
   version, timed beside it, the library yardsticks and its bound. (c) One
   fsd50k train step through the kernel held to the plain fbank's at
   phase 6's bars, then 2 warm-up and 10 timed steps. (d)
   ``psla-torch-train --preset fsd50k`` (``cli.run``) for 1 epoch on (a)'s
   datafiles: the fbank launches must be the train steps plus every eval
   batch, the CSVs finite. (e) ``smoke.run`` and ``smoke.run_protocol`` on
   the card (B0, T=64, bfloat16): artifacts, labels added, launches counted. (f)
   ``verify_release`` on a ``file://`` URL of a seeded B2 ``.pth`` of 200
   classes (``module.`` prefixes, an ``_fc``): every stage ok against the
   mAP ``tools/ensemble`` gives the file, the probabilities within 1e-4 of
   the plain ``predict_long``. (g) ``flagship.run`` at audioset_full width
   (B2, T=1056, batch 128, bfloat16; 512 train and 128 val clips, 3
   epochs), killed at epoch 2's first print step and resumed: every epoch
   completed, the summary beside phase 6's float32 bare step.
10. The ResNet50 and MobileNetV2 backbones (``--model resnet|mbnet``:
   ResNetAttention and MBNet) at the audioset_full widths (527 classes,
   T=1056, 128 mels, float32 with TF32 off unless stated) on seeded
   weights (``seeded_state_dict``), for each of the two: (a) a 2-member
   ensemble through ``InferenceEngine.batch_probs`` at micro-batch 16, one
   fbank launch a dispatch (counted), the probabilities within 1e-4 of the
   same members on the plain fbank, then the clips/s of full dispatches in
   float32 and bfloat16; (b) the train step at batch 100 (mixup 0.5,
   SpecAugment 48/192, Adam past warmup; the largest batch that fits, if
   100 does not) held to the plain fbank's step at phase 6's bars, then 2
   warm-up and 10 timed steps beside phase 6's B2 step; (c)
   ``psla-torch-predict`` on a 60 s clip within 1e-4 of ``predict_long`` on
   the plain fbank (ResNet through the pooling statistics, MBNet through
   the length-weighted fallback), ``tools/ensemble.main`` on 2 saved
   members stacked and ``--sequential`` within 1e-5, launches counted as in
   phase 8, and ``convert_ckpt`` round-tripping a member. Then (d)
   ``psla-torch-train --model resnet`` (``cli.run``) for 1 epoch on phase
   7's corpus writer (300 train and 100 val clips of 10 s) from
   ``impretrain`` with a seeded torchvision-layout ``resnet50-seeded.pth``
   named by ``PSLA_TPU_IMAGENET_CKPT``: the run's initial stem the fresh
   init's, every other backbone entry the file's; the fbank launches the
   train steps plus the eval batches; the CSVs finite; the wa checkpoint
   served through ``InferenceEngine``. ``--profile`` adds the device time by
   group of each backbone's train step.
11. Multi-seed ensemble training (``--ensemble-seeds``) at the audioset_full
   widths (B2, 4 heads, 527 classes, T=1056, batch 100, float32 with TF32
   off): (a) ``parallel.ensemble.make_ensemble_train_step`` at E=2 on seeded
   weights, one shared int16 batch and each member's own draws: the fbank
   launches of one step (set to 0 just before, read just after) must be E,
   each member held to the single-model step fed its draws (loss and
   running statistics 1e-5, parameters 2 x lr); then 2 warm-up and 10
   timed steps (device ms by CUDA events, clips/s of the shared stream,
   peak memory) beside phase 6's step, and one timed step at E=10, the
   reference's ensemble size. (b) ``make_ensemble_eval_step`` on a batch
   of 100: one fbank launch, each member within 1e-5 of its own eval
   step, both timed. (c) ``psla-torch-train --ensemble-seeds 2``
   (``cli.run``) on phase 7's corpus writer with the val list as the eval
   set, 2 epochs, wa over 1-2, then ``--resume --n-epochs 3``: each run's
   fbank launches E x its train steps plus its eval batches; the stacked
   checkpoints' step, ``seed_result.csv``'s rows, the seed-mean and
   per-seed prediction matrices, the ``best``/``wa`` extracts; and
   ``tools/ensemble.ensemble_eval`` on best_seed0 and best_seed1 on the
   card, within 1e-5 of the protocol's per-seed matrices.
12. Data parallelism (``torch.distributed``). NCCL takes one rank a card,
   so world 2 runs under gloo with both ranks on cuda:0: two processes
   sharing one card, not scaling. (a) World 1 under NCCL (RANK=0,
   WORLD_SIZE=1, ``maybe_initialize``): the batch-100 step through the
   mesh held to phase 6's one-process step (loss and running statistics
   1e-5, parameters 2 x lr), one fbank launch, then timed. (b) World 2,
   50 clips a rank, from (a)'s state and draws: the first step held to
   (a)'s at the JAX package's data-parallel bars (tests/test_parallel.py:
   90-100) and the statistics within 1e-5, one launch a rank a step, the
   timed steps (1 warm-up and 3 on the shared card, 2 and 10 on N cards)
   and each rank's peak memory, and the eval step of a global
   batch, gathered, within 1e-5 of the one-process eval step. (c)
   ``psla-torch-train --num-devices 2`` (``cli.run`` in each spawned rank)
   on phase 7's corpus writer: 2 epochs, then 1 and ``--resume`` to 2;
   each rank's launches equal its steps plus its eval batches, only rank
   0 writes, the resume samples and draws alike. (d) Serving:
   ``num_devices=2`` raising on one card, naming it.
   ``--data-parallel N`` runs this phase alone on N cards under NCCL, one
   rank a card (a 4-card machine: ``--data-parallel 4``); its (d) serves
   with N replicas on cuda:0..N-1, held within 1e-5 of one device, one
   launch a replica a dispatch, timed beside one device, with where a
   dispatch's time goes (host issue, the input copies, each card's
   kernels).
13. bfloat16 training (``--dtype bfloat16``) and int8 activation
   compression (``--act-compress``) at the audioset_full widths (B2, 4
   heads, 527 classes, T=1056, batch 100) from phase 6's seeded weights,
   int16 batch and draws; parameters, statistics and Adam stay float32.
   (a) One bf16 step through the fbank kernel (one launch, counted) held to
   the same step through the plain fbank at phase 6's bars (loss and
   running statistics within 1e-5, parameters within 2 x lr); then
   remat=True from the same start, loss within 1e-5 and parameters within
   2 x lr. (b) q8save and qdq bf16 steps from the same start against (a)'s
   uncompressed step, at the JAX package's bars (tests/test_qsave.py):
   q8save's loss within 1e-6 and gradient cosine > 0.999, qdq's within
   5e-2 and > 0.9; each gradient differs from the uncompressed one. (c) 2
   warm-up and 10 timed steps each of bf16, bf16 + q8save and bf16 + qdq:
   device ms (CUDA events), wall ms, clips/s, peak memory (q8save's below
   bf16's), beside phase 6's float32 step; ``--profile`` adds the bf16
   step's device time by group. (d) One bf16 step each of ResNet50 and
   MobileNetV2 at batch 100, finite, its loss beside its float32 step's
   from the same start. (e) ``psla-torch-train --dtype bfloat16
   --act-compress q8save`` (``cli.run``) for 1 epoch on phase 7's corpus
   writer: the fbank launches the train steps plus every eval batch, the
   CSVs finite, the float32 wa checkpoint served through
   ``InferenceEngine``.
14. The one-time-step gradient and ensembles across ranks. (a) Raw
   ``F.batch_norm`` given a channels-last gradient with an odd stride on a
   size-1 last dimension ([4, 16, 2, 1], strides (32, 1, 16, 32)) against
   the same gradient contiguous, for a float32 input (cuDNN) and a bf16
   input with float32 parameters: the relative errors, which say whether
   the card shares the CPU's fault (reported); the port's ``BatchNorm``
   bit for bit in both. The B2 train step at ``--target_length 32`` (one
   time step after the last stride), batch 100, against the same step with
   a hook that makes the backbone output's gradient contiguous, cuDNN
   deterministic: each leaf's gradient within 1e-6 of its norm plus 1e-7 of
   the whole gradient's. (b) Under gloo with both ranks on
   cuda:0 (NCCL refuses two ranks on one card): E=2 and E=4 seeds on 2
   ranks (two rows, E/2 members a rank) from phase 11's seeded weights,
   one step at batch 50 held to the one-process ensemble step on the same
   batch and draws at phase 12's bars, E/2 fbank launches a rank (counted);
   ``psla-torch-train --ensemble-seeds 2 --num-devices 2`` (``cli.run`` in
   each rank) at the audioset_full preset on phase 7's corpus writer,
   batch 50, 1 epoch and ``--resume`` to 2: each rank's launches its steps
   plus its eval batches, only rank 0 writes, the stacked checkpoint holds
   both seeds; ``tools/ensemble --num-devices 2`` on the run's best members
   within 1e-5 of one process's. (c) ``--data-parallel N`` (N cards, NCCL,
   one rank a card, after phase 12): E=2 on two rows of N/2 cards, each
   row data-parallel on its own process group, held to the one-process
   step at phase 12's bars and timed a rank; ``--profile`` times it beside
   the same step without the seed losses' gather over every rank and
   phase 12's single-model step at the same clips a rank, and prints each
   one's device time by group (the NCCL collectives apart) over a
   profiled step.
15. Train-mode BatchNorm with its SiLU (``ops/bn_train.py``), run after
   phase 5: at every distinct (N, C, H, W, act) of B2's 69 BatchNorms in
   both recipes (batch 100 at T=1056, batch 24 at T=3000) the kernels
   against their plain version (``F.batch_norm`` then the activation): z,
   the batch mean and variance, the running statistics after one and two
   calls, dx, dweight and dbias, each within ``F32_REL_BAR`` of max |ref|;
   then the forward and backward timed at each shape (queued behind a
   sleep on the card, so that host launch time does not show) and summed
   over a step's layers beside their bytes bound (8 B an element forward,
   12 B backward), the plain version and the library calls, the kernels'
   sum held to at least 40% of the bound; an eval forward launches
   neither kernel. Every held train step (phases 6, 9, 10, 13) counts the
   kernels' launches: one forward and one backward a BatchNorm in float32
   (69 + 69 for B2), none in bf16; phase 12's synced ranks launch none.
   The kernels' record holds phase 6's count as ``launches`` (what the
   end of the run checks) and this phase's own as ``launches_sweep``.

The line before the last is a JSON object with one record per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import builtins
import concurrent.futures
import csv
import dataclasses
import json
import os
import re
import shutil
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from psla_tpu_torch import assets, cli
from psla_tpu_torch.config import from_preset
from psla_tpu_torch.data import native
from psla_tpu_torch.data.datafiles import (
    load_datafile,
    load_label_csv,
    make_name_dict,
    save_datafile,
)
from psla_tpu_torch.data.loader import AudioLoader, LoaderConfig
from psla_tpu_torch.data.sampler import compute_sample_weights, gen_weight_file
from psla_tpu_torch.data.wav import decode_wav, read_wav, resample, write_wav
from psla_tpu_torch.frontend import fbank_cuda
from psla_tpu_torch import ops
from psla_tpu_torch.frontend.augment import normalize
from psla_tpu_torch.frontend.fbank import (
    FbankConfig,
    fbank_batched,
    frontend_matrix,
    mel_banks,
    pad_or_truncate,
)
from psla_tpu_torch.frontend.pipeline import PreprocessConfig
from psla_tpu_torch.inference import _chunk_logmel, ensemble_probs, predict_long
from psla_tpu_torch.models import create_model
from psla_tpu_torch.models.convert import load_variables
from psla_tpu_torch.models.layers import BN_EPS, BN_MOMENTUM, BatchNorm
from psla_tpu_torch.models.pretrained import CKPT_ENV
from psla_tpu_torch.ops import bn_train, fused_mbconv, mbconv_vmem
from psla_tpu_torch.tools import compute_stats as stats_tool
from psla_tpu_torch.tools import convert_ckpt as convert_tool
from psla_tpu_torch.tools import ensemble as ensemble_tool
from psla_tpu_torch.tools import export as export_tool
from psla_tpu_torch.tools import flagship, prep_fsd, smoke, verify_release
from psla_tpu_torch.tools import predict as predict_tool
from psla_tpu_torch.tools import weight_averaging as wa_tool
from psla_tpu_torch.parallel import ensemble as ensemble_module
from psla_tpu_torch.parallel.ensemble import (
    EnsembleState,
    ensemble_layout,
    init_ensemble_state,
    local_members,
    make_ensemble_eval_step,
    make_ensemble_train_step,
    place_members,
)
from psla_tpu_torch.parallel.distributed import allgather_host, maybe_initialize
from psla_tpu_torch.parallel.mesh import make_mesh, shard_batch
from psla_tpu_torch.tools.serve import InferenceEngine, make_server
from psla_tpu_torch.train.ensemble_loop import EnsembleTrainer
from psla_tpu_torch.train.loop import Trainer
from psla_tpu_torch.train.optim import psla_lr_schedule
from psla_tpu_torch.train.state import create_train_state, replicate_state
from psla_tpu_torch.train.step import (
    _wav_batch,
    build_eval_step,
    build_train_step,
    draw_train,
    step_generator,
)

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): float32
# outside the tensor cores, and device memory bandwidth.
PEAK_F32_FLOP_S = 67e12
PEAK_BYTES_S = 3.35e12

BATCH, TARGET, N_CLASS, EFF_B, HEADS = 16, 1056, 527, 2, 4
TRAIN_BATCH = 128  # bench.py's training batch, for the fbank alone (phase 3)
SR = 16000
FBANK_ATOL = 2e-4  # log-mel, kernel vs its plain version (f32 sum order)
FFT_RTOL = 1e-4  # relative part of the JAX package's bar where an FFT is on either side
SERVE_ATOL = 1e-4  # probabilities, served vs the plain-fbank forward
SEEDS = (1, 2)
LONG_SECONDS = 25  # the long-clip request: 3 chunks of 1056 frames
DEVICE = "cuda"


def check(cond: bool, msg: str):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- phase 1-2


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def header():
    print(card())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")


LIBRARIES = {"fbank": fbank_cuda.LIBRARY, "mbconv_pass1": fused_mbconv.LIBRARY,
             "mbconv_pass2": fused_mbconv.PASS2_LIBRARY, "mbconv_v2": mbconv_vmem.LIBRARY,
             "bn_train": bn_train.LIBRARY}


def kernel_report(log: str) -> list[tuple[str, int, int]]:
    """(kernel, registers, spill-store bytes) of each entry in nvcc's
    ``-Xptxas -v`` report, the kernel named by its mangled name without the
    anonymous namespace."""
    out, name, spills = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+", "", m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append((name, int(m.group(1)), spills))
            name, spills = None, 0
    return out


def build():
    """Builds every kernel library at once (one nvcc each, in parallel) and
    prints each kernel's registers and spills."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(LIBRARIES)) as pool:
        list(pool.map(lambda lib: lib.load(), LIBRARIES.values()))
    print(f"build: {time.perf_counter() - t0:.2f} s for {', '.join(LIBRARIES)}")
    for name, lib in LIBRARIES.items():
        for kernel, regs, spills in kernel_report(lib.log):
            print(f"  {name}: {kernel}: {regs} registers, {spills} bytes spilled")


# ---------------------------------------------------------------- phase 3


def tones(rng: np.random.Generator, n: int, count: int = 3) -> np.ndarray:
    t = np.arange(n) / SR
    x = 0.05 * rng.standard_normal(n)
    for f in rng.uniform(100.0, 4000.0, count):
        x += 0.2 * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    return x.astype(np.float32)


def ragged_batch(cfg: FbankConfig, seed: int = 0):
    """[16, N] waveforms and lengths: full clips, one short, one of length
    0, one longer than the buffer, one with a digitally silent tail."""
    rng = np.random.default_rng(seed)
    n = cfg.buffer_length(TARGET)
    wav = np.stack([tones(rng, n) for _ in range(BATCH)])
    lengths = np.full(BATCH, n, np.int32)
    lengths[1] = 3 * SR + 123
    lengths[2] = 0
    lengths[3] = n + 5000
    wav[1, lengths[1]:] = 0.0
    wav[2] = 0.0
    wav[4, n // 2:] = 0.0
    return wav, lengths


def fbank_bound(cfg: FbankConfig, lengths: np.ndarray, n: int, target: int = TARGET) -> dict:
    """Least time for this batch's log-mel: the larger of its operations
    over the float32 peak and its bytes over the memory rate.

    Only the valid frames need work (the kernel writes zeros past them).
    A frame needs DC removal, pre-emphasis and the window (5 flop a sample),
    a real FFT of the padded window (2.5 n log2 n flop), the power spectrum
    (3 a bin), the mel banks' non-zeros only (2 each) and the floor and log
    (2 a mel bin). The bytes are the samples those frames read, the
    lengths, the [B, T, n_mels] output, the window and the banks'
    non-zeros. ``dense_flop`` is what the TPU kernel's formulation (and
    this kernel's before its redesign) does for the same frames: frames @ A
    and power @ banks^T as dense products."""
    valid = [min(cfg.num_frames(min(int(x), n)), target) for x in lengths]
    frames = sum(valid)
    samples = sum(cfg.buffer_length(v) for v in valid if v)
    nfft, nb = cfg.padded_window_size, cfg.num_spectrum_bins
    nm, ws = cfg.num_mel_bins, cfg.window_size
    nnz = int(np.count_nonzero(mel_banks(cfg)))
    flop = frames * (5 * ws + 2.5 * nfft * float(np.log2(nfft)) + 3 * nb + 2 * nnz + 2 * nm)
    nbytes = 4 * (samples + len(lengths) + len(lengths) * target * nm + ws + nnz)
    t_ops, t_bytes = flop / PEAK_F32_FLOP_S, nbytes / PEAK_BYTES_S
    return {"ms": max(t_ops, t_bytes) * 1e3,
            "by": "operations" if t_ops >= t_bytes else "bytes",
            "flop": flop, "bytes": nbytes, "ops_ms": t_ops * 1e3,
            "bytes_ms": t_bytes * 1e3, "frames": frames, "banks_nnz": nnz,
            "dense_flop": frames * (2 * ws * 2 * nb + 2 * nb * nm + 3 * nb)}


def fbank_lowering(wav: torch.Tensor, lengths: torch.Tensor, cfg: FbankConfig,
                   method: str) -> torch.Tensor:
    """A lowering of fbank.py ('fft', or 'gemm': the TPU kernel's dense
    form), padded to TARGET."""
    logmel, _ = fbank_batched(wav, lengths, cfg, method=method)
    return pad_or_truncate(logmel, TARGET)


def kernel_phase() -> dict:
    # the plain versions' matmuls must be full float32 (PyTorch's default)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    cfg = FbankConfig()
    wav, lengths = ragged_batch(cfg)
    wav_t = torch.from_numpy(wav).cuda()
    len_t = torch.from_numpy(lengths).cuda()
    n_short = cfg.num_frames(int(lengths[1]))
    errs = {}
    for precision in ("highest", "high", "default"):
        c = dataclasses.replace(cfg, precision=precision)
        got = fbank_cuda.fbank_cuda(wav_t, len_t, c, TARGET)
        ref = fbank_cuda.fbank_plain(wav_t, len_t, c, TARGET)
        torch.cuda.synchronize()
        check(got.shape == (BATCH, TARGET, cfg.num_mel_bins), f"shape {got.shape}")
        check(bool(torch.isfinite(got).all()), "non-finite log-mel")
        check(bool((got[2] == 0).all()), "zero-length clip has non-zero frames")
        check(bool((got[1, n_short:] == 0).all()) and bool((got[1, :n_short] != 0).any()),
              "short clip is not masked past its frames")
        errs[precision] = float((got - ref).abs().max())
        print(f"fbank precision={precision}: max abs err vs plain ('fft64') "
              f"{errs[precision]:.3e} (bar {FBANK_ATOL})")
        check(errs[precision] <= FBANK_ATOL, f"fbank {precision} error {errs[precision]}")
        # The float32 lowerings round relative to a frame's energy; on these
        # tones the lowest mel bands hold ~1e-7 of it, so each misses the
        # exact log-mel there by up to a few 1e-3 (cuFFT more than cuBLAS).
        # Each is held to the JAX package's bar where an FFT is on either
        # side (2e-4 abs + 1e-4 relative, test_goldens.py:50), widened by
        # that lowering's own distance from the plain version where that is
        # larger.
        for lowering in ("fft", "gemm"):
            low = fbank_lowering(wav_t, len_t, c, lowering)
            own = float((low - ref).abs().max())
            excess = float(((got - low).abs() - FBANK_ATOL - FFT_RTOL * low.abs()).max())
            err = float((got - low).abs().max())
            print(f"  vs the float32 '{lowering}' lowering: max abs {err:.3e}, over the "
                  f"2e-4 + 1e-4 relative bar by {excess:.3e}; the lowering's own distance "
                  f"from plain {own:.3e}")
            check(excess <= 0 or err <= own + FBANK_ATOL,
                  f"fbank {precision} vs '{lowering}': {err} (its own error {own})")

    frames = wav_t.unfold(-1, cfg.window_size, cfg.window_shift)[:, :TARGET]
    frames = frames.reshape(-1, cfg.window_size).contiguous()
    a = torch.from_numpy(frontend_matrix(cfg)).cuda()
    kernel = lambda: fbank_cuda.fbank_cuda(wav_t, len_t, cfg, TARGET)  # noqa: E731
    plain = lambda: fbank_cuda.fbank_plain(wav_t, len_t, cfg, TARGET)  # noqa: E731
    library = lambda: torch.matmul(frames, a)  # noqa: E731
    rfft = lambda: torch.fft.rfft(frames, n=cfg.padded_window_size)  # noqa: E731
    # in turns, so drift on the card touches each alike
    order = (("plain", plain), ("kernel", kernel), ("library", library), ("rfft", rfft),
             ("rfft", rfft), ("library", library), ("kernel", kernel), ("plain", plain))
    times: dict[str, list[float]] = {}
    for name, fn in order:
        times.setdefault(name, []).append(cuda_ms(fn))
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    bound = fbank_bound(cfg, lengths, wav.shape[1])
    print(f"fbank [{BATCH}, {wav.shape[1]}] -> [{BATCH}, {TARGET}, {cfg.num_mel_bins}]: "
          f"kernel {ms['kernel']:.4f} ms {times['kernel']}, plain ('fft64') {ms['plain']:.4f} ms "
          f"{times['plain']}, library (cuBLAS f32 frames[{frames.shape[0]},"
          f"{frames.shape[1]}] @ A[{a.shape[0]},{a.shape[1]}]) {ms['library']:.4f} ms, "
          f"cuFFT rfft of the same frames {ms['rfft']:.4f} ms")
    print(f"fbank bound {bound['ms']:.4f} ms ({bound['by']}) for {bound['frames']} valid "
          f"frames: {bound['flop'] / 1e9:.4f} GFLOP (FFT + {bound['banks_nnz']} bank "
          f"non-zeros) = {bound['ops_ms']:.4f} ms at {PEAK_F32_FLOP_S / 1e12:.0f} TFLOP/s; "
          f"{bound['bytes'] / 1e6:.3f} MB = {bound['bytes_ms']:.4f} ms at "
          f"{PEAK_BYTES_S / 1e12:.2f} TB/s; kernel at {bound['ms'] / ms['kernel']:.1%} "
          f"of it")
    print(f"fbank dense formulation (frames @ A, power @ banks^T) would be "
          f"{bound['dense_flop'] / 1e9:.3f} GFLOP, "
          f"{bound['dense_flop'] / bound['flop']:.1f}x the bound's operations")
    check(ms["kernel"] < ms["library"],
          f"fbank kernel {ms['kernel']:.4f} ms is not below cuBLAS frames @ A "
          f"{ms['library']:.4f} ms")
    train_batch_phase(cfg)
    print(f"LAUNCHES after the comparison: {fbank_cuda.LAUNCHES}")
    print("kernels: ['fbank']")
    return {
        "name": "fbank",
        "route": "cuda",
        "source": "psla_tpu_torch/csrc/fbank.cu",
        "replaces": "psla_tpu/frontend/fbank_pallas.py:85",
        "launches": None,
        "max_abs_err": max(errs.values()),  # vs the plain version
        "ms": ms["kernel"],
        "plain_ms": ms["plain"],
        "bound_ms": bound["ms"],
        "bound_by": bound["by"],
        "library_ms": ms["library"],
    }


def train_batch_phase(cfg: FbankConfig):
    """The kernel at the audioset_full training batch: 128 full-length clips
    (no lengths), T=1056. Times it beside its bound and the plain version,
    and holds one launch to the plain version."""
    rng = np.random.default_rng(3)
    n = cfg.buffer_length(TARGET)
    wav = torch.from_numpy(np.stack([tones(rng, n) for _ in range(TRAIN_BATCH)])).cuda()
    got = fbank_cuda.fbank_cuda(wav, None, cfg, TARGET)
    err = float((got - fbank_cuda.fbank_plain(wav, None, cfg, TARGET)).abs().max())
    check(err <= FBANK_ATOL, f"fbank at batch {TRAIN_BATCH}: error {err}")
    kernel = lambda: fbank_cuda.fbank_cuda(wav, None, cfg, TARGET)  # noqa: E731
    plain = lambda: fbank_cuda.fbank_plain(wav, None, cfg, TARGET)  # noqa: E731
    times: dict[str, list[float]] = {}
    for name, fn in (("kernel", kernel), ("plain", plain), ("plain", plain),
                     ("kernel", kernel)):
        times.setdefault(name, []).append(cuda_ms(fn, reps=10))
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    bound = fbank_bound(cfg, np.full(TRAIN_BATCH, n), n)
    print(f"fbank training batch [{TRAIN_BATCH}, {n}] -> [{TRAIN_BATCH}, {TARGET}, "
          f"{cfg.num_mel_bins}]: kernel {ms['kernel']:.4f} ms {times['kernel']}, plain "
          f"('fft64') {ms['plain']:.4f} ms; bound {bound['ms']:.4f} ms ({bound['by']}: "
          f"{bound['bytes'] / 1e6:.3f} MB, {bound['flop'] / 1e9:.4f} GFLOP); kernel at "
          f"{bound['ms'] / ms['kernel']:.1%} of it; max abs err vs plain {err:.3e}")


# ---------------------------------------------------------------- phase 4


def seeded_state_dict(seed: int, n_class: int = N_CLASS,
                      model: str = "efficientnet") -> dict[str, torch.Tensor]:
    """Random weights of ``model`` (B2 for EfficientNet) drawn with numpy
    from a seed: BatchNorm statistics mean ~N(0, 0.1), var ~U(0.5, 1.5), so
    eval outputs are not flat; pooling heads at the reference's U(-a, a),
    a = sqrt(6 / fan_in), with head weights that sum to 1 as the
    reference's 1/H do. Conv kernels (and MBNet's classifier) are normal
    with variance 1.9 / fan_in. Over fan-out (the JAX package's He init)
    the activations shrink block by block and the output stops depending
    on the input; at 2 / fan_in the forward turns chaotic and f32 rounding
    (another batch size, another cuDNN algorithm) grows to ~1e-4 in the
    probabilities. 1.9 keeps the output input-dependent and rounding at
    ~1e-7. ResNet's last BatchNorm of each residual branch (``bn3``)
    scales by U(0.1, 0.3): every block adds its branch to the identity, and
    over 16 blocks the probabilities would saturate at 0 and 1."""
    sd = create_model(model, label_dim=n_class, eff_b=EFF_B, head_num=HEADS).state_dict()
    rng = np.random.default_rng(seed)
    bns = {k[: -len(".running_mean")] for k in sd if k.endswith(".running_mean")}
    out = {}
    for k, v in sd.items():
        prefix, leaf = k.rsplit(".", 1)
        shape = tuple(v.shape)
        if prefix in bns:
            scale = (0.1, 0.3) if prefix.endswith(".bn3") else (0.8, 1.2)
            x = {"running_mean": lambda: rng.normal(0.0, 0.1, shape),
                 "running_var": lambda: rng.uniform(0.5, 1.5, shape),
                 "weight": lambda: rng.uniform(*scale, shape),
                 "bias": lambda: rng.normal(0.0, 0.1, shape)}[leaf]()
        elif k == "attention.head_weight":  # sums to 1: probabilities stay in (0, 1)
            x = rng.uniform(0.5, 1.5, shape)
            x = x / x.sum()
        elif k.startswith("attention.") and leaf == "weight":
            a = np.sqrt(6.0 / shape[1])
            x = rng.uniform(-a, a, shape)
        elif leaf == "weight":  # conv kernel [out, in / groups, k, k], classifier
            x = rng.normal(0.0, np.sqrt(1.9 / np.prod(shape[1:])), shape)
        else:  # pooling, squeeze-excite and classifier biases
            x = rng.normal(0.0, 0.1, shape)
        out[k] = torch.from_numpy(x.astype(np.float32))
    return out


def member(sd: dict, dtype: torch.dtype, model: str = "efficientnet"):
    out = create_model(model, label_dim=N_CLASS, eff_b=EFF_B, head_num=HEADS, dtype=dtype)
    out.load_state_dict(sd)
    return out


def arch(model: torch.nn.Module) -> str:
    """The model's family and widths, for the printed lines."""
    if hasattr(model, "effnet"):
        return f"B{model.b}, {model.head_num} heads"
    return "ResNet50, 1 head" if hasattr(model, "attention") else "MobileNetV2"


def wav_bytes(x: np.ndarray, sr: int) -> bytes:
    pcm = (np.clip(x, -1, 1) * 32767).astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
    return hdr + fmt + b"data" + struct.pack("<I", len(pcm)) + pcm


def make_requests(rng: np.random.Generator, chunk: int):
    """(name, body, content type, 16 kHz waveform the server sees or None)."""
    reqs = []
    for i, frac in enumerate((0.1, 0.25, 0.4, 0.6, 0.8, 1.0)):  # of one chunk
        x = tones(rng, int(frac * chunk))
        reqs.append((f"wav16k_{i}", wav_bytes(x, SR), "audio/wav",
                     decode_wav(wav_bytes(x, SR))[0]))
    for i, frac in enumerate((0.2, 0.3, 0.5)):
        x = tones(rng, int(frac * chunk))
        body = json.dumps({"wav": x.tolist(), "sample_rate": SR}).encode()
        reqs.append((f"json_{i}", body, "application/json", x))
    x44 = tones(rng, int(0.5 * chunk / SR * 44100))
    reqs.append(("wav44k", wav_bytes(x44, 44100), "audio/wav",
                 resample(decode_wav(wav_bytes(x44, 44100))[0], 44100, SR)))
    x_long = tones(rng, LONG_SECONDS * SR)
    reqs.append(("long25s", wav_bytes(x_long, SR), "audio/wav",
                 decode_wav(wav_bytes(x_long, SR))[0]))
    reqs.append(("malformed", b"this is not a wav file", "audio/wav", None))
    return reqs


def post(url: str, body: bytes, ctype: str):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            code, payload = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, payload = e.code, json.loads(e.read())
    return code, payload, (time.perf_counter() - t0) * 1e3


def probs_of(payload: dict) -> np.ndarray:
    p = np.full(N_CLASS, np.nan)
    for e in payload["top_k"]:
        p[e["index"]] = e["prob"]
    return p


def dispatch_rate(engine: InferenceEngine, rng: np.random.Generator, reps: int = 10):
    """clips/s of full micro-batches through ``batch_probs`` (host clock
    around work that ends in a device-to-host copy)."""
    n = engine.chunk_samples
    wav = np.stack([tones(rng, n) for _ in range(engine.batch_size)])
    mean = wav.mean(axis=1).astype(np.float32)
    lengths = np.full(engine.batch_size, n, np.int32)
    for _ in range(2):
        engine.batch_probs(wav, mean, lengths)
    t0 = time.perf_counter()
    for _ in range(reps):
        probs = engine.batch_probs(wav, mean, lengths)
    dt = (time.perf_counter() - t0) / reps
    return engine.batch_size / dt, dt * 1e3, probs


def serving_phase(profile: bool) -> int:
    """Serves the requests; returns the fbank kernel's launches meanwhile."""
    names = make_name_dict(assets.label_csv_for("audioset"))
    check(len(names) == N_CLASS, f"{len(names)} labels")
    config = PreprocessConfig(target_length=TARGET)  # 'auto': the kernel on cuda
    plain_config = dataclasses.replace(config, fbank_method="gemm")
    sds = [seeded_state_dict(s) for s in SEEDS]

    t0 = time.perf_counter()
    engine = InferenceEngine([member(sd, torch.float32) for sd in sds], config, names,
                             batch_size=BATCH, batch_window_ms=20.0, device=DEVICE)
    print(f"engine up in {time.perf_counter() - t0:.2f} s (B{EFF_B}, {HEADS} heads, "
          f"{N_CLASS} classes, T={TARGET}, batch {BATCH}, float32, {len(SEEDS)} members)")
    server = make_server(engine, port=0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        reqs = make_requests(np.random.default_rng(7), engine.chunk_samples)
        fbank_cuda.LAUNCHES = 0
        with concurrent.futures.ThreadPoolExecutor(len(reqs)) as pool:
            results = list(pool.map(
                lambda r: post(f"{base}/predict?top_k={N_CLASS}", r[1], r[2]), reqs))
        launches = fbank_cuda.LAUNCHES
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        engine.close()
        thread.join(timeout=30)

    print(f"launches during serving: {launches}")
    print(f"/stats: {stats}")
    served = {}
    for (name, _, _, _), (code, payload, ms) in zip(reqs, results):
        if name == "malformed":
            print(f"  {name}: HTTP {code} {payload.get('error', '')[:60]!r} ({ms:.1f} ms)")
            check(code == 400, f"malformed body got HTTP {code}")
            continue
        check(code == 200, f"{name}: HTTP {code} {payload}")
        p = probs_of(payload)
        check(bool(np.all(np.isfinite(p))), f"{name}: non-finite or missing probabilities")
        check(bool(np.all((p > 0) & (p < 1))), f"{name}: probabilities outside (0, 1)")
        served[name] = p
        print(f"  {name}: HTTP 200, {payload['duration_s']} s audio, client "
              f"{ms:.1f} ms, server {payload['latency_ms']} ms, probs "
              f"[{p.min():.4f}, {p.max():.4f}], top {payload['top_k'][0]['label']!r}")
    check(len(served) >= 8, f"only {len(served)} answers")
    check(stats["batches"] >= 1 and stats["mean_batch_occupancy"] > 1.0,
          f"no shared micro-batches: {stats}")
    check(stats["long_clips"] == 1, f"long clip path not taken: {stats}")

    # the same clips through the plain fbank and the same members on the card
    worst = 0.0
    members = engine.members
    with torch.inference_mode():
        for name in ("json_0", "wav16k_2", "wav16k_5"):
            x = next(r[3] for r in reqs if r[0] == name)
            buf = np.zeros((1, engine.chunk_samples), np.float32)
            buf[0, : x.size] = x
            logmel = _chunk_logmel(
                torch.from_numpy(buf).to(DEVICE),
                torch.tensor([float(x.mean())], device=DEVICE),
                torch.tensor([x.size], dtype=torch.int32, device=DEVICE), plain_config)
            ref = np.mean([m(logmel)[0].float().cpu().numpy() for m in members], axis=0)
            err = float(np.abs(served[name] - ref).max())
            worst = max(worst, err)
            print(f"  {name}: served vs plain-fbank forward max abs {err:.3e}")
        x = next(r[3] for r in reqs if r[0] == "long25s")
        ref = np.mean([predict_long(m, x, plain_config, device=DEVICE) for m in members],
                      axis=0)
        err = float(np.abs(served["long25s"] - ref).max())
        worst = max(worst, err)
        print(f"  long25s: served vs plain-fbank predict_long max abs {err:.3e}")
    check(worst <= SERVE_ATOL, f"served probabilities off the plain path by {worst}")
    table = np.stack(list(served.values()))
    print(f"served vs plain path: max abs {worst:.3e} (bar {SERVE_ATOL}); probability "
          f"spread over classes {np.ptp(table, axis=1).min():.3f}, over clips "
          f"{np.ptp(table, axis=0).max():.3e}")

    rate, ms, probs32 = dispatch_rate(engine, np.random.default_rng(11))
    print(f"full {BATCH}-clip dispatch, float32, {len(members)} members: "
          f"{ms:.2f} ms, {rate:.1f} clips/s")
    if profile:
        profile_dispatch(engine)
    del engine, members
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    bf16 = InferenceEngine([member(sd, torch.bfloat16) for sd in sds], config, names,
                           batch_size=BATCH, device=DEVICE)
    bf16.close()
    rate, ms, probs16 = dispatch_rate(bf16, np.random.default_rng(11))
    check(bool(np.all(np.isfinite(probs16))), "bfloat16 probabilities not finite")
    print(f"full {BATCH}-clip dispatch, bfloat16, {len(SEEDS)} members: "
          f"{ms:.2f} ms, {rate:.1f} clips/s; max abs vs float32 "
          f"{float(np.abs(probs16 - probs32).max()):.3e}")
    bf16_held_to_per_call(bf16, sds, config)
    if profile:
        profile_dispatch(bf16)
    return launches


class CountCasts(TorchDispatchMode):
    """Counts the dtype casts of the calls run under it: all of them, and
    those whose source shares its storage with one of ``weights``."""

    def __init__(self, weights):
        super().__init__()
        self.ptrs = {t.untyped_storage().data_ptr() for t in weights}
        self.casts = self.weight_casts = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        # under inference_mode a cast reaches the mode as aten.to, else as _to_copy
        if (func.overloadpacket in (torch.ops.aten._to_copy, torch.ops.aten.to)
                and out is not args[0] and out.dtype != args[0].dtype):
            self.casts += 1
            self.weight_casts += args[0].untyped_storage().data_ptr() in self.ptrs
        return out


def bf16_held_to_per_call(engine: InferenceEngine, sds: list[dict], config):
    """The bf16 engine's dispatch (its serving copies, weights cast once:
    ``layers.for_inference``) against the per-call bf16 modules, which cast
    every weight at each call, on the same log-mel: max abs (expected 0,
    held at SERVE_ATOL), the fbank launches of the dispatch, each side's
    dtype casts in one dispatch, and the dispatch's work timed on each side
    (the per-call modules compute as the engine did before it held serving
    copies)."""
    rng = np.random.default_rng(12)
    n = engine.chunk_samples
    wav = np.stack([tones(rng, n) for _ in range(engine.batch_size)])
    mean = wav.mean(axis=1).astype(np.float32)
    lengths = np.full(engine.batch_size, n, np.int32)
    fbank_cuda.LAUNCHES = 0
    got = engine.batch_probs(wav, mean, lengths)
    launches = fbank_cuda.LAUNCHES
    modules = [member(sd, torch.bfloat16).to(DEVICE) for sd in sds]
    to = dict(device=DEVICE)
    args = (torch.from_numpy(wav).to(**to), torch.from_numpy(mean).to(**to),
            torch.from_numpy(lengths).to(**to))
    with torch.inference_mode():
        logmel = _chunk_logmel(*args, config)
        acc = modules[0](logmel).float()
        for m in modules[1:]:
            acc = acc + m(logmel).float()
        want = (acc / len(modules)).cpu().numpy()
        casts = {}
        for what, members in (("engine", engine.members), ("per-call modules", modules)):
            weights = [t for m in members for t in (*m.parameters(), *m.buffers())]
            with CountCasts(weights) as c:
                ensemble_probs(members, *args, config)
                torch.cuda.synchronize()
            casts[what] = c
        # the per-call modules compute as the engine did before it held
        # serving copies
        times = {what: cuda_ms(lambda: ensemble_probs(members, *args, config), reps=10)
                 for what, members in (("serving copies", engine.members),
                                       ("per-call modules", modules))}
    err = float(np.abs(got - want).max())
    print("bfloat16 dispatch's work from the card's waveforms (CUDA events, host launch "
          "time included): " + ", ".join(f"{k} {v:.2f} ms" for k, v in times.items()))
    print(f"bfloat16 dispatch (serving copies) vs the per-call bf16 modules on the same "
          f"log-mel: max abs {err:.3e} (bar {SERVE_ATOL}); fbank launches {launches}; "
          f"dtype casts in one dispatch: engine {casts['engine'].casts} "
          f"({casts['engine'].weight_casts} of weights), per-call modules "
          f"{casts['per-call modules'].casts} ({casts['per-call modules'].weight_casts} "
          f"of weights)")
    check(err <= SERVE_ATOL, f"bf16 serving copies off the per-call modules by {err}")
    check(launches == 1, f"bf16 dispatch: {launches} fbank launches, want 1")
    check(casts["engine"].weight_casts == 0,
          f"the bf16 engine cast {casts['engine'].weight_casts} weights in a dispatch")


def profile_dispatch(engine: InferenceEngine):
    """Device time by kernel over one full dispatch."""
    from torch.profiler import ProfilerActivity, profile

    n = engine.chunk_samples
    wav = np.zeros((engine.batch_size, n), np.float32)
    args = (wav, np.zeros(engine.batch_size, np.float32),
            np.full(engine.batch_size, n, np.int32))
    engine.batch_probs(*args)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.batch_probs(*args)
    averages = prof.key_averages()
    print(averages.table(sort_by="self_cuda_time_total", row_limit=20))
    counts = {e.key: e.count for e in averages if e.key in ("aten::copy_", "aten::_to_copy")}
    print(f"profiled {engine.members[0].dtype} dispatch: {counts}")


# ---------------------------------------------------------------- phase 5

PEAK_BF16_FLOP_S = 989e12  # H100 SXM tensor cores, dense (data sheet)
PEAK_TF32_FLOP_S = 495e12
# (products the card computes per product, their rate): the v1 passes on
# the CUDA cores in float32; v2 on the tensor cores, float32 as 3xTF32
# (three TF32 products each) and fast=True in bf16.
PRODUCT_ROUTES = {"f32": (1, PEAK_F32_FLOP_S), "3xtf32": (3, PEAK_TF32_FLOP_S),
                  "bf16": (1, PEAK_BF16_FLOP_S)}
ROUTES = {"mbconv_v2": "3xtf32", "mbconv_pass1": "f32", "mbconv_pass2": "f32"}
V2_ATOL, V1_ATOL, F32_RTOL = 3e-6, 2e-6, 1e-5  # the JAX package's f32 bars
FAST_TOL = 5e-2  # fast=True (bfloat16 operands), the JAX package's bar
# A full-width block that misses the f32 bar above only through its long
# sums (up to 2112 expanded channels into one output, 33792 pixels into one
# mean) is held to this bar on max |err| / max |ref| instead.
F32_REL_BAR = 1e-5
V1_TILES = (2048, 256)  # the JAX default and a tile shorter than a map row
SWISH_FLOP = 4  # exp, add, divide, and the negation


def block_work(b: int, h: int, w: int, cin: int, ce: int, cse: int, cout: int,
               k: int, stride: int, has_expand: bool) -> dict:
    """Operations and bytes one block needs, for v2 and for v1's passes.

    Operations: the expand product, bias and swish; the k*k taps, bias and
    swish; the squeeze-excite mean, MLP and gate; the project product, bias
    and residual. ``products`` is the part the tensor cores could take.
    Bytes: each input read once and each output written once, float32
    (block input, folded weights, block output; pass 1 writes the [B, Ce]
    sums, pass 2 reads the [B, Ce] gate)."""
    ho, wo = -(-h // stride), -(-w // stride)
    rin, rout = b * h * w, b * ho * wo
    exp_prod = 2 * rin * cin * ce if has_expand else 0
    exp_rest = rin * ce * (1 + SWISH_FLOP) if has_expand else 0
    taps = rout * ce * (2 * k * k + 1 + SWISH_FLOP)
    mean = rout * ce
    se = b * (2 * ce * cse + cse * (1 + SWISH_FLOP) + 2 * cse * ce + 4 * ce)
    proj_prod = 2 * rout * ce * cout
    proj_rest = rout * ce + rout * cout * (2 if stride == 1 and cin == cout else 1)
    w_front = (cin * ce + ce if has_expand else 0) + k * k * ce + ce
    w_se = 2 * ce * cse + cse + ce
    w_proj = ce * cout + cout
    x_bytes, y_bytes = 4 * rin * cin, 4 * rout * cout
    front = exp_prod + exp_rest + taps
    return {
        "mbconv_v2": {"flop": front + mean + se + proj_prod + proj_rest,
                      "products": exp_prod + proj_prod,
                      "bytes": x_bytes + y_bytes + 4 * (w_front + w_se + w_proj)},
        "mbconv_pass1": {"flop": front + mean, "products": exp_prod,
                         "bytes": x_bytes + 4 * (w_front + b * ce)},
        "mbconv_pass2": {"flop": front + proj_prod + proj_rest, "products": exp_prod + proj_prod,
                         "bytes": x_bytes + y_bytes + 4 * (w_front + w_proj + b * ce)},
    }


def ops_s(work: dict, route: str) -> float:
    """Seconds of the block's operations at the card's peaks: the products
    at the rate of the route that computes them (``PRODUCT_ROUTES``), the
    rest at the float32 rate."""
    per_product, peak = PRODUCT_ROUTES[route]
    return (per_product * work["products"] / peak
            + (work["flop"] - work["products"]) / PEAK_F32_FLOP_S)


def bound_ms(work: dict, route: str) -> tuple[float, str]:
    """Least time: the larger of operations over the peaks (``ops_s``) and
    bytes over the memory rate."""
    t_ops, t_bytes = ops_s(work, route), work["bytes"] / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def hold(what: str, got: torch.Tensor, ref: torch.Tensor, atol: float, rtol: float,
         rel_bar: float | None = None) -> float:
    """allclose(got, ref, atol, rtol), or max |err| <= rel_bar * max |ref|."""
    got, ref = got.float(), ref.float()
    check(got.shape == ref.shape, f"{what}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    err = float((got - ref).abs().max())
    if bool(torch.allclose(got, ref, atol=atol, rtol=rtol)):
        return err
    scale = float(ref.abs().max())
    check(rel_bar is not None and err <= rel_bar * scale,
          f"{what}: max abs err {err:.3e}, max |ref| {scale:.3e} (atol {atol}, rtol {rtol}, "
          f"relative bar {rel_bar})")
    print(f"    {what}: misses atol {atol}/rtol {rtol}; held to {err / scale:.2e} of "
          f"max |ref| {scale:.3e} (bar {rel_bar})")
    return err


def capture_blocks(model) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Each MBConv block's input and output (NCHW) in one eval forward of a
    16-clip log-mel batch made by the fbank kernel."""
    cfg = FbankConfig()
    rng = np.random.default_rng(21)
    n = cfg.buffer_length(TARGET)
    wav = torch.from_numpy(np.stack([tones(rng, n) for _ in range(BATCH)])).to(DEVICE)
    pre = PreprocessConfig(target_length=TARGET)
    logmel = normalize(fbank_cuda.fbank_cuda(wav, None, cfg, TARGET), pre.norm_mean,
                       pre.norm_std)
    captured = []
    hooks = [blk.register_forward_hook(lambda m, i, o: captured.append((i[0], o)))
             for blk in model.effnet._blocks]
    try:
        with torch.inference_mode(), module_precision():
            model(logmel)
    finally:
        for hk in hooks:
            hk.remove()
    return captured


def module_precision():
    """cuDNN in full float32 for the module forwards, scoped."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False)


def mbconv_phase() -> list[dict]:
    """Every B2 block at serving width through the three MBConv kernels."""
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    model = member(seeded_state_dict(SEEDS[0]), torch.float32).to(DEVICE).eval()
    blocks = list(model.effnet._blocks)
    captured = capture_blocks(model)
    check(len(captured) == len(blocks) == 23, f"{len(captured)} blocks captured")
    xs = [i.permute(0, 2, 3, 1).contiguous() for i, _ in captured]
    refs = [o.permute(0, 2, 3, 1) for _, o in captured]
    geo = [(blk._depthwise_conv.kernel_size[0], blk._depthwise_conv.stride[0])
           for blk in blocks]
    folded = [ops.fold_block(blk) for blk in blocks]
    n_s1 = sum(s == 1 for _, s in geo)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count

    # the main path: every block once through the public entry points
    fused_mbconv.LAUNCHES_PASS1 = fused_mbconv.LAUNCHES_PASS2 = mbconv_vmem.LAUNCHES = 0
    with torch.inference_mode():
        out_v2 = [ops.fused_mbconv_eval_v2(x, f, k, s, fast=False)
                  for x, f, (k, s) in zip(xs, folded, geo)]
        out_v1 = [ops.fused_mbconv_eval(x, f, k, fast=False, tile=V1_TILES[0])
                  if s == 1 else None for x, f, (k, s) in zip(xs, folded, geo)]
    torch.cuda.synchronize()
    launches = {"mbconv_v2": mbconv_vmem.LAUNCHES,
                "mbconv_pass1": fused_mbconv.LAUNCHES_PASS1,
                "mbconv_pass2": fused_mbconv.LAUNCHES_PASS2}
    print(f"launches over one sweep of the {len(blocks)} blocks: {launches}")
    check(launches == {"mbconv_v2": len(blocks), "mbconv_pass1": n_s1, "mbconv_pass2": n_s1},
          f"launch counts {launches}, expected {len(blocks)}/{n_s1}/{n_s1}")

    errs = {name: 0.0 for name in launches}
    times = {key: 0.0 for key in ("v2", "v2_fast", "v2_plain", "p1", "p2", "p1_plain",
                                  "p2_plain", "module", "module_s1")}
    # v2's phase kernels alone, summed over the sweep, fast=False and True
    phase_ms = {(fast, ph): 0.0 for fast in (False, True) for ph in mbconv_vmem.PHASES}
    bounds = {name: 0.0 for name in launches}
    by_ops = {name: 0.0 for name in launches}  # seconds at the peaks (ops_s)
    by_bytes = {name: 0.0 for name in launches}  # seconds at the memory rate
    bound_fast = 0.0
    total = {"flop": 0, "bytes": 0, "io_bytes": 0}
    max_sums = 0.0
    print(f"{'blk':>3} {'k':>1} {'s':>1} {'in -> out (NHWC)':>34} {'Ce':>5} "
          f"{'v2 err':>9} {'v2 fast':>9} {'vs module':>9} {'v1 err':>9} {'max|ref|':>9} "
          f"{'v2 ms':>8} {'A':>7} {'B':>7} {'C':>7} {'D':>7} "
          f"{'plain':>8} {'p1 ms':>8} {'p2 ms':>8} {'v1 plain':>8} "
          f"{'module':>8} {'bound':>8} {'by':>10} {'p1 CTAs/S/P':>12} {'p2 CTAs/S/P':>12} "
          f"{'p1 bound':>8} {'p2 bound':>8}")
    for i, (blk, x, ref, f, (k, s)) in enumerate(zip(blocks, xs, refs, folded, geo)):
        b, h, w, cin = x.shape
        ce, cse = f["wr"].shape
        cout = f["wp"].shape[1]
        work = block_work(b, h, w, cin, ce, cse, cout, k, s, "w1" in f)
        with torch.inference_mode():
            y = out_v2[i]
            v2_mod = hold(f"block {i} v2 vs module", y, ref, V2_ATOL, F32_RTOL, F32_REL_BAR)
            plain = mbconv_vmem.fused_mbconv_eval_v2_plain(x, f, k, s, fast=False)
            v2_err = hold(f"block {i} v2 vs plain", y, plain, V2_ATOL, F32_RTOL, F32_REL_BAR)
            yf = ops.fused_mbconv_eval_v2(x, f, k, s, fast=True)
            plain_f = mbconv_vmem.fused_mbconv_eval_v2_plain(x, f, k, s, fast=True)
            v2_fast = hold(f"block {i} v2 fast vs plain", yf, plain_f, FAST_TOL, FAST_TOL)
            for fast, first in ((False, y), (True, yf)):  # no atomics: the same bits
                check(torch.equal(first, ops.fused_mbconv_eval_v2(x, f, k, s, fast=fast)),
                      f"block {i} v2 fast={fast}: two launches differ")
            errs["mbconv_v2"] = max(errs["mbconv_v2"], v2_err)
            v1_err = float("nan")
            if s == 1:
                v1_err = 0.0
                hold(f"block {i} v1 vs module", out_v1[i], ref, V1_ATOL, F32_RTOL, F32_REL_BAR)
                hw = float(h * w)
                for tile in V1_TILES:
                    for fast in (False, True):
                        tol = (FAST_TOL, FAST_TOL) if fast else (V1_ATOL, F32_RTOL)
                        rel = None if fast else F32_REL_BAR
                        sums = fused_mbconv.mbconv_pass1(x, f, k, fast, tile)
                        again = fused_mbconv.mbconv_pass1(x, f, k, fast, tile)
                        check(torch.equal(sums, again),
                              f"block {i} pass 1 tile {tile} fast={fast}: two launches differ")
                        sums_p = fused_mbconv.pass1_plain(x, f, k, fast, tile)
                        e1 = hold(f"block {i} pass 1 tile {tile} fast={fast} (means)",
                                  sums / hw, sums_p / hw, *tol, rel)
                        gate = fused_mbconv.se_gate(sums_p / hw, f).contiguous()
                        out = fused_mbconv.mbconv_pass2(x, f, gate, k, fast, tile)
                        again = fused_mbconv.mbconv_pass2(x, f, gate, k, fast, tile)
                        check(torch.equal(out, again),
                              f"block {i} pass 2 tile {tile} fast={fast}: two launches differ")
                        out_p = fused_mbconv.pass2_plain(x, f, gate, k, fast, tile)
                        e2 = hold(f"block {i} pass 2 tile {tile} fast={fast}", out, out_p,
                                  *tol, rel)
                        if not fast:
                            max_sums = max(max_sums, float(sums_p.abs().max()))
                            errs["mbconv_pass1"] = max(errs["mbconv_pass1"], e1 * hw)
                            errs["mbconv_pass2"] = max(errs["mbconv_pass2"], e2)
                            v1_err = max(v1_err, e2)

            tile = V1_TILES[0]
            row = {
                "v2_plain": lambda: mbconv_vmem.fused_mbconv_eval_v2_plain(x, f, k, s, False),
                "v2": lambda: ops.fused_mbconv_eval_v2(x, f, k, s, False),
                "v2_fast": lambda: ops.fused_mbconv_eval_v2(x, f, k, s, True),
            }
            if s == 1:
                gate = fused_mbconv.se_gate(
                    fused_mbconv.pass1_plain(x, f, k, False, tile) / float(h * w), f
                ).contiguous()
                row.update({
                    "p1_plain": lambda: fused_mbconv.pass1_plain(x, f, k, False, tile),
                    "p1": lambda: fused_mbconv.mbconv_pass1(x, f, k, False, tile),
                    "p2": lambda: fused_mbconv.mbconv_pass2(x, f, gate, k, False, tile),
                    "p2_plain": lambda: fused_mbconv.pass2_plain(x, f, gate, k, False, tile),
                })
            nchw = captured[i][0]
            with module_precision():
                row["module"] = lambda: blk(nchw)
                t = {key: cuda_ms(fn, reps=5, warmup=1) for key, fn in row.items()}
            for fast in (False, True):
                _, launch = mbconv_vmem.phase_launcher(x, f, k, s, fast)
                launch()  # every phase once: each later one reads its inputs
                for ph, mask in mbconv_vmem.PHASES.items():
                    t[(fast, ph)] = cuda_ms(lambda: launch(mask), reps=5, warmup=1)
                    phase_ms[(fast, ph)] += t[(fast, ph)]
        for key in row:
            times[key] += t[key]
        if s == 1:
            times["module_s1"] += t["module"]
        for name in launches:
            if name == "mbconv_v2" or s == 1:
                bounds[name] += bound_ms(work[name], ROUTES[name])[0]
                by_ops[name] += ops_s(work[name], ROUTES[name])
                by_bytes[name] += work[name]["bytes"] / PEAK_BYTES_S
        bound_fast += bound_ms(work["mbconv_v2"], "bf16")[0]
        total["flop"] += work["mbconv_v2"]["flop"]
        total["bytes"] += work["mbconv_v2"]["bytes"]
        total["io_bytes"] += 4 * (x.numel() + y.numel())
        shape = f"{tuple(x.shape)}->{tuple(y.shape)}"
        grid1 = grid2 = "-"
        if s == 1:
            g1 = fused_mbconv.pass1_geometry(b, h, w, cin, ce, k, sm_count)
            g2 = fused_mbconv.pass2_geometry(b, h, w, cin, ce, cout, k, sm_count)
            check(g1.ctas >= sm_count, f"block {i}: pass 1 runs {g1.ctas} blocks of threads")
            check(g2.ctas >= sm_count, f"block {i}: pass 2 runs {g2.ctas} blocks of threads")
            grid1 = f"{g1.ctas}/{g1.slices}/{g1.p}"
            grid2 = f"{g2.ctas}/{g2.slices}/{g2.p}"
        print(f"{i:>3} {k:>1} {s:>1} {shape:>34} {ce:>5} {v2_err:>9.2e} {v2_fast:>9.2e} "
              f"{v2_mod:>9.2e} {v1_err:>9.2e} {float(ref.abs().max()):>9.3e} "
              f"{t['v2']:>8.4f} "
              + " ".join(f"{t[(False, ph)]:>7.4f}" for ph in mbconv_vmem.PHASES) +
              f" {t['v2_plain']:>8.4f} {t.get('p1', float('nan')):>8.4f} "
              f"{t.get('p2', float('nan')):>8.4f} "
              f"{t.get('p1_plain', float('nan')) + t.get('p2_plain', float('nan')):>8.4f} "
              f"{t['module']:>8.4f} {bound_ms(work['mbconv_v2'], '3xtf32')[0]:>8.4f} "
              f"{bound_ms(work['mbconv_v2'], '3xtf32')[1]:>10} {grid1:>12} {grid2:>12} "
              f"{bound_ms(work['mbconv_pass1'], 'f32')[0] if s == 1 else float('nan'):>8.4f} "
              f"{bound_ms(work['mbconv_pass2'], 'f32')[0] if s == 1 else float('nan'):>8.4f}")

    print(f"all {len(blocks)} blocks: {total['flop'] / 1e9:.2f} GFLOP, "
          f"{total['bytes'] / 1e6:.1f} MB (block inputs, outputs, weights; float32), of "
          f"which block inputs and outputs {total['io_bytes'] / 1e6:.1f} MB")
    print(f"mbconv_v2 over {len(blocks)} blocks: kernel {times['v2']:.4f} ms (fast=True "
          f"{times['v2_fast']:.4f} ms), plain {times['v2_plain']:.4f} ms, module block "
          f"forwards (several PyTorch calls each, cuDNN f32) {times['module']:.4f} ms; "
          f"bound {bounds['mbconv_v2']:.4f} ms with the products as 3xTF32 at "
          f"{PEAK_TF32_FLOP_S / 1e12:.0f} TFLOP/s, the rest at {PEAK_F32_FLOP_S / 1e12:.0f} "
          f"(fast=True: {bound_fast:.4f} ms, the products in bf16 at "
          f"{PEAK_BF16_FLOP_S / 1e12:.0f}); kernel at {bounds['mbconv_v2'] / times['v2']:.1%} "
          f"(fast=True {bound_fast / times['v2_fast']:.1%})")
    for fast in (False, True):
        parts = ", ".join(f"{ph} {phase_ms[(fast, ph)]:.4f}" for ph in mbconv_vmem.PHASES)
        print(f"mbconv_v2 phase kernels alone, fast={fast}, summed over the {len(blocks)} "
              f"blocks (ms): {parts}; together "
              f"{sum(phase_ms[(fast, ph)] for ph in mbconv_vmem.PHASES):.4f} against the "
              f"call's {times['v2_fast' if fast else 'v2']:.4f}; bound "
              f"{bound_fast if fast else bounds['mbconv_v2']:.4f}")
    print(f"v1 over the {n_s1} stride-1 blocks, tile {V1_TILES[0]}: pass 1 "
          f"{times['p1']:.4f} ms (plain {times['p1_plain']:.4f}, bound "
          f"{bounds['mbconv_pass1']:.4f}), pass 2 {times['p2']:.4f} ms (plain "
          f"{times['p2_plain']:.4f}, bound {bounds['mbconv_pass2']:.4f}); module block "
          f"forwards of the same blocks {times['module_s1']:.4f} ms")
    print(f"max abs err vs plain (fast=False): {errs}; pass 1's is of its [B, Ce] sums, "
          f"which reach {max_sums:.4e}")
    src = {"mbconv_pass1": ("mbconv_pass1.cu", "psla_tpu/ops/fused_mbconv.py:182", "p1"),
           "mbconv_pass2": ("mbconv_pass2.cu", "psla_tpu/ops/fused_mbconv.py:209", "p2"),
           "mbconv_v2": ("mbconv_v2.cu", "psla_tpu/ops/mbconv_vmem.py:185", "v2")}
    records = []
    for name, (source, replaces, key) in src.items():
        records.append({
            "name": name,
            "route": "cuda",
            "source": f"psla_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": errs[name],
            "ms": times[key],
            "plain_ms": times[f"{key}_plain"],
            "bound_ms": bounds[name],
            "bound_by": "operations" if by_ops[name] >= by_bytes[name] else "bytes",
            "library_ms": times["module"] if name == "mbconv_v2" else None,
        })
    return records


# ---------------------------------------------------------------- phase 15

# Train-mode BatchNorm with its SiLU (ops/bn_train.py) at the layer shapes
# of B2's two recipes: (time axis, batch) of audioset_full and fsd50k.
BN_RECIPES = {"audioset_full": (1056, 100), "fsd50k": (3000, 24)}
BN_FW_BYTES, BN_BW_BYTES = 8, 12  # read x, write z; read x and dz, write dx
BN_SEED = 61


def bn_layers(target: int) -> dict[tuple[int, int, int, str | None], int]:
    """B2's BatchNorms at ``target`` frames: (C, H, W, act) -> how many
    layers of the model have that shape (read by hooks on one eval
    forward of one clip)."""
    model = create_model("efficientnet", eff_b=EFF_B, head_num=HEADS).to(DEVICE)
    seen: dict[tuple[int, int, int, str | None], int] = {}

    def record(mod, args):
        x, act = args[0], (args[1] if len(args) > 1 else None)
        key = (x.shape[1], x.shape[2], x.shape[3], act)
        seen[key] = seen.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(record) for m in model.modules()
             if isinstance(m, BatchNorm)]
    with torch.no_grad():
        model(torch.zeros(1, target, 128, device=DEVICE))
    for h in hooks:
        h.remove()
    return seen


def bn_case(n: int, c: int, h: int, w: int, act: str | None, momentum: float) -> dict:
    """The kernels against their plain version at one shape: z, the batch
    mean and unbiased variance (a call at momentum 1), the running
    statistics after one and two calls from seeded ones, and dx, dweight
    and dbias; each as (max |err|, max |err| / max |ref|)."""
    gen = torch.Generator(device=DEVICE).manual_seed(BN_SEED + c + h * w)
    x = (torch.randn((n, c, h, w), generator=gen, device=DEVICE) * 2.0
         + torch.linspace(-3.0, 3.0, c, device=DEVICE)[:, None, None])
    dz = torch.randn((n, c, h, w), generator=gen, device=DEVICE)
    weight = 1.0 + 0.25 * torch.randn(c, generator=gen, device=DEVICE)
    bias = 0.1 * torch.randn(c, generator=gen, device=DEVICE)
    rm0 = 0.1 * torch.randn(c, generator=gen, device=DEVICE)
    rv0 = 1.0 + torch.rand(c, generator=gen, device=DEVICE)
    outs = {}
    for side, fn in (("kernel", bn_train.bn_act), ("plain", bn_train.bn_act_plain)):
        rm, rv = rm0.clone(), rv0.clone()
        xr, wr, br = (t.clone().requires_grad_() for t in (x, weight, bias))
        z = fn(xr, rm, rv, wr, br, momentum, BN_EPS, act)
        z.backward(dz)
        once = (rm.clone(), rv.clone())
        with torch.no_grad():
            fn(x, rm, rv, weight, bias, momentum, BN_EPS, act)
            bm, bv = torch.zeros(c, device=DEVICE), torch.ones(c, device=DEVICE)
            fn(x, bm, bv, weight, bias, 1.0, BN_EPS, act)
        outs[side] = {"z": z.detach(), "batch mean": bm, "batch var": bv,
                      "running mean 1": once[0], "running var 1": once[1],
                      "running mean 2": rm, "running var 2": rv, "dx": xr.grad,
                      "dweight": wr.grad, "dbias": br.grad}
        del z, xr
    errs = {k: float((outs["kernel"][k] - v).abs().max()) for k, v in outs["plain"].items()}
    return {k: (e, e / float(outs["plain"][k].abs().max())) for k, e in errs.items()}


def queued_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events), queued
    behind a sleep of ~50 ms on the card, so that the host's time to
    launch them does not show between small kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bn_times(n: int, c: int, h: int, w: int, act: str | None) -> dict[str, float]:
    """Device ms of the forward and the backward at one shape
    (``queued_ms``): the kernels, the plain version and the library calls
    (``F.batch_norm`` then ``F.silu``)."""
    gen = torch.Generator(device=DEVICE).manual_seed(BN_SEED)
    x = torch.randn((n, c, h, w), generator=gen, device=DEVICE)
    dz = torch.randn((n, c, h, w), generator=gen, device=DEVICE)
    weight, bias = torch.ones(c, device=DEVICE), torch.zeros(c, device=DEVICE)
    rm, rv = torch.zeros(c, device=DEVICE), torch.ones(c, device=DEVICE)

    def library(t, rm_, rv_, w_, b_, m, eps, a):
        y = F.batch_norm(t, rm_, rv_, w_, b_, True, m, eps)
        return F.silu(y) if a == "silu" else y

    out = {}
    for side, fn in (("kernel", bn_train.bn_act), ("plain", bn_train.bn_act_plain),
                     ("library", library)):
        with torch.no_grad():
            out[f"{side} fw"] = queued_ms(
                lambda: fn(x, rm, rv, weight, bias, BN_MOMENTUM, BN_EPS, act))
        xg = x.clone().requires_grad_()
        z = fn(xg, rm, rv, weight, bias, BN_MOMENTUM, BN_EPS, act)
        out[f"{side} bw"] = queued_ms(lambda: torch.autograd.grad(z, xg, dz, retain_graph=True))
        del z, xg
    return out


def bn_phase() -> dict:
    """Phase 15: the BatchNorm kernels at every distinct layer shape of both
    recipes, held to their plain version at ``F32_REL_BAR``, then timed and
    summed over a step's layers beside the bytes bound, the plain version
    and the library calls; the summed kernel time must be at least 40% of
    the bound in each recipe. An eval forward launches neither kernel.
    Returns the kernels' record: its times are audioset_full's (the main
    path's shapes), ``launches_sweep`` counts this phase's launches; the
    main path's count a train step is phase 6's (``main`` sets it)."""
    t_phase = time.perf_counter()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst: dict[str, float] = {}
    worst_abs = 0.0
    bn_train.LAUNCHES_FW = bn_train.LAUNCHES_BW = 0
    record = {"name": "bn_train", "route": "cuda", "source": "psla_tpu_torch/csrc/bn_train.cu",
              "replaces": None, "bound_by": "bytes", "recipes": {}}
    for recipe, (target, batch) in BN_RECIPES.items():
        layers = bn_layers(target)
        elements = sum(c * h * w * k for (c, h, w, _), k in layers.items())
        print(f"{recipe}: {sum(layers.values())} BatchNorms, {len(layers)} distinct (C, H, W, "
              f"act), {elements:,} elements a clip at T={target}, batch {batch}")
        check(sum(layers.values()) == 69, f"{recipe}: {sum(layers.values())} BatchNorms")
        totals: dict[str, float] = {}
        bound = {"fw": 0.0, "bw": 0.0}
        for (c, h, w, act), count in sorted(layers.items(), key=lambda kv: -kv[0][1] * kv[0][2]):
            before = (bn_train.LAUNCHES_FW, bn_train.LAUNCHES_BW)
            errs = bn_case(batch, c, h, w, act, BN_MOMENTUM)
            check((bn_train.LAUNCHES_FW - before[0], bn_train.LAUNCHES_BW - before[1]) == (3, 1),
                  "the kernels were not launched at their shape")
            for k, (e_abs, e) in errs.items():
                worst[k] = max(worst.get(k, 0.0), e)
                worst_abs = max(worst_abs, e_abs)
            bad = {k: e for k, (_, e) in errs.items() if not e <= F32_REL_BAR}
            check(not bad, f"{recipe} [{batch}, {c}, {h}, {w}] act {act}: off the plain "
                           f"version by {bad} of max |ref| (bar {F32_REL_BAR})")
            ms = bn_times(batch, c, h, w, act)
            elems = batch * c * h * w
            for k, v in ms.items():
                totals[k] = totals.get(k, 0.0) + count * v
            bound["fw"] += count * elems * BN_FW_BYTES / PEAK_BYTES_S * 1e3
            bound["bw"] += count * elems * BN_BW_BYTES / PEAK_BYTES_S * 1e3
            launch = [bn_train.geometry(batch, c, h * w, 4 if h * w % 4 == 0 else 1, k, sms)
                      for k in (1, 2)]
            print(f"  [{batch}, {c}, {h}, {w}] act {act} x{count}: "
                  + ", ".join(f"{d} G={g} {'held' if held else 'streamed'}"
                              for d, (g, held) in zip(("fw", "bw"), launch))
                  + f"; worst err {max(e for _, e in errs.values()):.2e}; "
                  f"ms fw kernel {ms['kernel fw']:.4f} plain {ms['plain fw']:.4f} library "
                  f"{ms['library fw']:.4f}, bw kernel {ms['kernel bw']:.4f} plain "
                  f"{ms['plain bw']:.4f} library {ms['library bw']:.4f}; bound fw "
                  f"{elems * BN_FW_BYTES / PEAK_BYTES_S * 1e3:.4f} bw "
                  f"{elems * BN_BW_BYTES / PEAK_BYTES_S * 1e3:.4f}")
            torch.cuda.empty_cache()
        kernel = totals["kernel fw"] + totals["kernel bw"]
        bound_ms = bound["fw"] + bound["bw"]
        print(f"{recipe}, a step's 69 BatchNorms: bound {bound_ms:.3f} ms (bytes: fw "
              f"{bound['fw']:.3f}, bw {bound['bw']:.3f}), kernel {kernel:.3f} ms (fw "
              f"{totals['kernel fw']:.3f}, bw {totals['kernel bw']:.3f}; {bound_ms / kernel:.1%} "
              f"of the bound), plain {totals['plain fw'] + totals['plain bw']:.3f} ms (fw "
              f"{totals['plain fw']:.3f}, bw {totals['plain bw']:.3f}), library "
              f"{totals['library fw'] + totals['library bw']:.3f} ms (fw "
              f"{totals['library fw']:.3f}, bw {totals['library bw']:.3f}) ({card()})")
        check(bound_ms / kernel >= 0.4, f"{recipe}: the kernels at {bound_ms / kernel:.1%} of "
                                        f"their bound (want 40%)")
        record["recipes"][recipe] = {
            "bound_ms": bound_ms, "ms": kernel,
            "plain_ms": totals["plain fw"] + totals["plain bw"],
            "library_ms": totals["library fw"] + totals["library bw"]}
    print("worst error over the shapes, of max |ref|: "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f" (bar {F32_REL_BAR}); worst max abs err {worst_abs:.3e}")
    record.update(record["recipes"]["audioset_full"])
    record["max_abs_err"] = worst_abs
    record["launches_sweep"] = bn_train.LAUNCHES_FW + bn_train.LAUNCHES_BW
    model = create_model("efficientnet", eff_b=EFF_B, head_num=HEADS).to(DEVICE)
    before = (bn_train.LAUNCHES_FW, bn_train.LAUNCHES_BW)
    with torch.no_grad():
        model(torch.randn(2, TARGET, 128, device=DEVICE))
    torch.cuda.synchronize()
    eval_launches = (bn_train.LAUNCHES_FW - before[0], bn_train.LAUNCHES_BW - before[1])
    print(f"eval forward: BatchNorm kernel launches {eval_launches}")
    check(eval_launches == (0, 0), "an eval forward launched the BatchNorm kernels")
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return record


# ---------------------------------------------------------------- phase 6

# audioset_full (psla_tpu/config.py:169-173, 86-91): B2, 4 heads, 527
# classes, T=1056, 128 mels, batch 100, mixup 0.5, SpecAugment 48/192,
# drop-connect 0.2, Adam at lr 1e-4 with warmup and decay 0.5 from epoch 10.
STEP_BATCH = 100
STEP_LR, STEPS_PER_EPOCH = 1e-4, 20_000  # an epoch of ~2M clips at batch 100
START_STEP = 2000  # past the 1000-step warmup, whose first 50 rates are 0
WARM_STEPS, TIMED_STEPS = 2, 10
STEP_LOSS_ATOL = 1e-5  # the loss through the kernel vs the plain fbank, and remat
STATS_ATOL = 1e-5  # running statistics after that step (0.01 of a batch's)
# Parameters after that step are held to 2 x the step's learning rate:
# Adam's first update of a parameter is g / (|g| + eps) * lr, at most lr in
# size, so a gradient whose sign the two fbanks' ~1e-6 log-mel difference
# flips moves it by up to 2 lr.


def train_config() -> PreprocessConfig:
    return PreprocessConfig(fbank=FbankConfig(precision="high"), target_length=TARGET,
                            freq_mask=48, time_mask=192, mixup_rate=0.5)


def train_batch(cfg: PreprocessConfig, seed: int = 5, batch: int = STEP_BATCH,
                n_class: int = N_CLASS) -> dict:
    """The loader's batch dict: int16 wire waveforms (tones plus noise) with
    ragged lengths, their full-clip means, multi-hot labels, and mixup
    partners that are the batch rolled by one."""
    rng = np.random.default_rng(seed)
    n = cfg.fbank.buffer_length(cfg.target_length)
    wav = np.stack([tones(rng, n) for _ in range(batch)])
    lengths = np.full(batch, n, np.int32)
    lengths[::7] = rng.integers(n // 8, n, lengths[::7].size)  # short clips
    lengths[3] = 0
    for i, length in enumerate(lengths):
        wav[i, length:] = 0.0
    pcm = np.round(np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    f32 = pcm.astype(np.float32) * np.float32(2.0 ** -15)
    means = np.array([f32[i, :length].mean() if length else 0.0
                      for i, length in enumerate(lengths)], np.float32)
    labels = (rng.uniform(size=(batch, n_class)) < 0.01).astype(np.float32)
    labels[np.arange(batch), rng.integers(n_class, size=batch)] = 1.0
    return {"wav": pcm, "wav_mean": means, "length": lengths, "labels": labels,
            "mix_wav": np.roll(pcm, 1, 0), "mix_wav_mean": np.roll(means, 1),
            "mix_length": np.roll(lengths, 1), "mix_labels": np.roll(labels, 1, 0)}


def train_state(sd: dict, remat: bool = False, n_class: int = N_CLASS, lr: float = STEP_LR,
                steps_per_epoch: int = STEPS_PER_EPOCH, model_name: str = "efficientnet",
                dtype: torch.dtype = torch.float32, act_compress: str = "none"):
    model = create_model(model_name, label_dim=n_class, eff_b=EFF_B, head_num=HEADS,
                         remat=remat, dtype=dtype, act_compress=act_compress)
    model.load_state_dict(sd)
    schedule = psla_lr_schedule(lr, steps_per_epoch, lrscheduler_start=10,
                                lrscheduler_decay=0.5, warmup=True)
    return create_train_state(model, schedule, step=START_STEP, device=DEVICE)


def max_diff(a: dict, b: dict, keys) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in keys)


def step_held_to_plain(cfg: PreprocessConfig, batch: dict, make_state, what: str):
    """The main path: one train step through the fbank kernel (its launch
    count set to 0 just before and read just after: one launch), held to
    the same step, with the same draws, through the plain fbank ('fft64'):
    the loss, the running statistics and the parameters (the latter within
    2 x the step's learning rate). Returns (the stepped state, its loss, its state_dict, the step
    function, the generator, the draws, the BatchNorm kernels' (forward, backward) launches in
    the step)."""
    size = len(batch["wav"])
    state = make_state()
    dtype = getattr(state.model, "dtype", torch.float32)
    precision = "float32 (TF32 off)" if dtype == torch.float32 else str(dtype).split(".")[1]
    if dtype == torch.float32:
        check(not torch.backends.cuda.matmul.allow_tf32
              and not torch.backends.cudnn.allow_tf32, "TF32 is on for a float32 train step")
    lr = state.schedule(state.step)
    param_atol = 2 * lr
    plain_state = make_state()
    step = build_train_step(cfg)
    plain_step = build_train_step(dataclasses.replace(cfg, fbank_method="fft64"))
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    draws = draw_train(gen, state.model, size, cfg)
    n_keep = 0 if draws.keep is None else draws.keep.shape[0]
    n_class = batch["labels"].shape[1]
    print(f"{what}: {arch(state.model)}, {n_class} classes, T={cfg.target_length}, batch "
          f"{size}, {precision}, mixup {cfg.mixup_rate}, SpecAugment "
          f"{cfg.freq_mask}/{cfg.time_mask}, drop-connect on {n_keep} blocks, Adam at "
          f"lr {lr} (step {state.step}); int16 batch [{size}, {batch['wav'].shape[1]}], "
          f"{int((batch['length'] == 0).sum())} empty and "
          f"{int((batch['length'] < batch['length'].max()).sum())} short clips")

    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    # the BatchNorm kernels take every float32 layer, once each way
    n_bn = sum(isinstance(m, BatchNorm) for m in state.model.modules())
    want_bn = (n_bn, n_bn) if dtype == torch.float32 else (0, 0)
    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = bn_train.LAUNCHES_FW = bn_train.LAUNCHES_BW = 0
    state, metrics = step(state, batch, draws)
    torch.cuda.synchronize()
    launches = fbank_cuda.LAUNCHES
    bn_launches = (bn_train.LAUNCHES_FW, bn_train.LAUNCHES_BW)
    print(f"launches in one train step: fbank {launches}; BatchNorm forward and backward "
          f"{bn_launches} ({n_bn} BatchNorms)")
    check(launches == 1, f"{launches} fbank launches in one train step")
    check(bn_launches == want_bn, f"BatchNorm kernel launches {bn_launches}, want {want_bn}")
    loss = float(metrics["loss"])
    check(np.isfinite(loss), f"train loss {loss}")
    plain_state, plain_metrics = plain_step(plain_state, batch, draws)
    torch.cuda.synchronize()
    check(fbank_cuda.LAUNCHES == 1, "the plain fbank launched the kernel")
    after, plain_after = state.model.state_dict(), plain_state.model.state_dict()
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    params = [k for k, _ in state.model.named_parameters()]
    loss_err = abs(loss - float(plain_metrics["loss"]))
    stats_err, param_err = max_diff(after, plain_after, stats), max_diff(after, plain_after, params)
    moved = sum(bool((after[k] != before[k]).any()) for k in params)
    stats_moved = sum(bool((after[k] != before[k]).any()) for k in stats)
    share = np.mean([float(((after[k] - plain_after[k]).abs() > 1e-6).float().mean())
                     for k in params])
    print(f"loss {loss:.6f}; vs the same step through the plain fbank ('fft64'): loss "
          f"{loss_err:.3e} (bar {STEP_LOSS_ATOL}), running statistics {stats_err:.3e} (bar "
          f"{STATS_ATOL}), parameters {param_err:.3e} (bar {param_atol}; mean share of a "
          f"tensor's entries off by > 1e-6: {share:.2e}); {moved}/{len(params)} parameter "
          f"and {stats_moved}/{len(stats)} statistics tensors changed")
    check(loss_err <= STEP_LOSS_ATOL, f"train loss off the plain fbank's by {loss_err}")
    check(stats_err <= STATS_ATOL, f"running statistics off by {stats_err}")
    check(param_err <= param_atol, f"parameters off by {param_err}")
    check(moved == len(params) and stats_moved == len(stats),
          f"{moved}/{len(params)} parameters and {stats_moved}/{len(stats)} statistics moved")
    return state, loss, after, step, gen, draws, bn_launches


def timed_steps(step, state, batch: dict, gen: torch.Generator, cfg: PreprocessConfig,
                members: int = 0, warm: int | None = None, timed: int | None = None):
    """``warm`` (default WARM_STEPS), then ``timed`` (TIMED_STEPS) steps with
    fresh draws each: (state, device ms of each step by CUDA events, wall ms
    a step, peak memory, losses); one fbank launch a step, counted. With
    ``members`` the state is an ensemble's: each step draws for every
    member, and launches once a member."""
    warm = WARM_STEPS if warm is None else warm
    timed = TIMED_STEPS if timed is None else timed
    size = len(batch["wav"])

    def draws():
        if not members:
            return draw_train(gen, state.model, size, cfg)
        return [draw_train(gen, state.members[0].model, size, cfg) for _ in range(members)]

    for _ in range(warm):
        state, metrics = step(state, batch, draws())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fbank_cuda.LAUNCHES = 0
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(timed)]
    losses = []
    t0 = time.perf_counter()
    for start, end in events:
        start.record()
        state, metrics = step(state, batch, draws())
        end.record()
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / timed
    peak = torch.cuda.max_memory_allocated()
    device_ms = [a.elapsed_time(b) for a, b in events]
    losses = [float(x) for x in losses]
    want = timed * max(members, 1)
    check(fbank_cuda.LAUNCHES == want, f"{fbank_cuda.LAUNCHES} fbank launches in {timed} "
                                       f"steps, want {want}")
    check(bool(np.all(np.isfinite(losses))), f"train losses {losses}")
    return state, device_ms, wall_ms, peak, losses


def training_phase(profile: bool) -> tuple[int, float, float, tuple[int, int]]:
    """The audioset_full train step at full width; returns the fbank
    kernel's launches in the step that is held to the plain fbank, the
    timed steps' clips/s and device ms, and the BatchNorm kernels'
    (forward, backward) launches in the held step."""
    cfg = train_config()
    batch = train_batch(cfg)
    sd = seeded_state_dict(SEEDS[0])
    state, loss, after, step, gen, draws, bn_launches = step_held_to_plain(
        cfg, batch, lambda: train_state(sd), "train step")
    launches = 1  # checked there
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]

    # remat: the same draws from the same start
    remat_state = train_state(sd, remat=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    remat_state, remat_metrics = step(remat_state, batch, draws)
    torch.cuda.synchronize()
    remat_peak = torch.cuda.max_memory_allocated()
    remat_err = abs(float(remat_metrics["loss"]) - loss)
    remat_stats = max_diff(remat_state.model.state_dict(), after, stats)
    print(f"remat=True: loss {remat_err:.3e} from remat=False (bar {STEP_LOSS_ATOL}), "
          f"running statistics {remat_stats:.3e}; peak memory {remat_peak / 2**30:.2f} GiB")
    check(remat_err <= STEP_LOSS_ATOL, f"remat loss off by {remat_err}")
    check(remat_stats <= STATS_ATOL, f"remat statistics off by {remat_stats}")
    del remat_state

    # time: warm-up steps, then timed steps with fresh draws each
    state, device_ms, wall_ms, peak, losses = timed_steps(step, state, batch, gen, cfg)
    print(f"train step, {TIMED_STEPS} steps after {WARM_STEPS} warm-up: device "
          f"{np.mean(device_ms):.2f} ms/step (CUDA events; {min(device_ms):.2f}-"
          f"{max(device_ms):.2f}), wall {wall_ms:.2f} ms/step, "
          f"{STEP_BATCH / wall_ms * 1e3:.1f} clips/s; peak memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated; remat=True {remat_peak / 2**30:.2f}); losses "
          f"{losses[0]:.4f} .. {losses[-1]:.4f}; step counter {state.step}")
    fbank_at_train_batch(cfg, batch, draws, float(np.mean(device_ms)))
    if profile:
        profile_train_step(state, step, batch, gen, cfg)
    return launches, STEP_BATCH / wall_ms * 1e3, float(np.mean(device_ms)), bn_launches


def fbank_at_train_batch(cfg: PreprocessConfig, batch: dict, draws, step_ms: float):
    """The kernel on a train step's mixed waveforms, beside its bound, its
    plain version and the library yardsticks, and its share of a step."""
    from psla_tpu_torch.frontend import augment

    wb = _wav_batch(batch, torch.device(DEVICE))
    wav, _, _ = augment.mixup_waveforms(
        wb.wav, wb.wav_mean, wb.length, wb.mix_wav, wb.mix_wav_mean, wb.mix_length,
        wb.labels, wb.mix_labels, draws.pre.mixup, cfg.mixup_rate)
    wav, lengths, fc = wav.contiguous(), wb.length, cfg.fbank
    frames = wav.unfold(-1, fc.window_size, fc.window_shift)[:, :TARGET]
    frames = frames.reshape(-1, fc.window_size).contiguous()
    a = torch.from_numpy(frontend_matrix(fc)).to(DEVICE)
    fns = {"kernel": lambda: fbank_cuda.fbank_cuda(wav, lengths, fc, TARGET),
           "plain": lambda: fbank_cuda.fbank_plain(wav, lengths, fc, TARGET),
           "library": lambda: torch.matmul(frames, a),
           "rfft": lambda: torch.fft.rfft(frames, n=fc.padded_window_size)}
    times: dict[str, list[float]] = {}
    for name in ("plain", "kernel", "library", "rfft", "rfft", "library", "kernel", "plain"):
        times.setdefault(name, []).append(cuda_ms(fns[name], reps=10))
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    err = float((fns["kernel"]() - fns["plain"]()).abs().max())
    check(err <= FBANK_ATOL, f"fbank in the train step: error {err}")
    bound = fbank_bound(fc, batch["length"], wav.shape[1])
    print(f"fbank in the train step, max abs err vs plain {err:.3e} (bar {FBANK_ATOL})")
    print(f"fbank in the train step [{STEP_BATCH}, {wav.shape[1]}] -> [{STEP_BATCH}, {TARGET}, "
          f"{fc.num_mel_bins}] ({bound['frames']} valid frames): kernel {ms['kernel']:.4f} ms "
          f"{times['kernel']}, plain ('fft64') {ms['plain']:.4f}, library (cuBLAS f32 "
          f"frames[{frames.shape[0]},{frames.shape[1]}] @ A) {ms['library']:.4f}, cuFFT rfft "
          f"{ms['rfft']:.4f}; bound {bound['ms']:.4f} ms ({bound['by']}: "
          f"{bound['bytes'] / 1e6:.3f} MB, {bound['flop'] / 1e9:.4f} GFLOP), kernel at "
          f"{bound['ms'] / ms['kernel']:.1%} of it; {ms['kernel'] / step_ms:.2%} of a "
          f"{step_ms:.2f} ms step")


# Device kernels of a train step by what they compute, matched on the
# kernel's name in this order (the first match wins).
KERNEL_GROUPS = (
    ("depthwise conv backward", r"conv_depthwise.*(backward|grad)"),
    ("depthwise conv forward", r"conv_depthwise"),
    ("BatchNorm backward", r"bn_bw|batch_norm_backward|batch_norm_collect_stat.*backward"),
    ("BatchNorm forward", r"bn_fw|batch_norm"),
    ("convolutions and products (cuDNN, cuBLAS)",
     r"xmma|implicit_gemm|wgrad|dgrad|gemm|cudnn|cutlass|sm90_|winograd|fft2d"),
    ("fbank kernel", r"fbank"),
    ("Adam (foreach)", r"foreach|adam"),
    ("host-device copies", r"Memcpy|Memset"),
)


def profile_train_step(state, step, batch: dict, gen: torch.Generator,
                       cfg: PreprocessConfig):
    """Device time by kernel over one train step, and by group."""
    from torch.profiler import ProfilerActivity, profile

    draws = draw_train(gen, state.model, STEP_BATCH, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch, draws)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    print(averages.table(sort_by="self_cuda_time_total", row_limit=30))
    groups, launches = device_groups(averages)
    print_groups("train step", groups, launches)


def device_groups(averages, groups=KERNEL_GROUPS) -> tuple[dict[str, float], int]:
    """A profile's device ms by group (``groups``: (name, pattern) pairs
    matched on the kernel's name in order), and its kernels and copies."""
    out: dict[str, float] = {}
    launches = 0
    for e in averages:
        if e.device_type != torch.autograd.DeviceType.CUDA or not e.self_device_time_total:
            continue
        launches += e.count
        name = next((g for g, pattern in groups if re.search(pattern, e.key, re.I)),
                    "elementwise and other (SiLU, squeeze-excite, mixup, masks, ...)")
        out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3
    return out, launches


def print_groups(what: str, groups: dict[str, float], launches: int):
    total = sum(groups.values())
    print(f"{what} device time by group ({total:.2f} ms in {launches} kernels and copies):")
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {name}: {ms:.2f} ms ({ms / total:.1%})")


# ---------------------------------------------------------------- phase 7

# The trainer end to end: psla-torch-train's entry point (cli.run) at the
# audioset_full preset on a seeded corpus of tone clips, cut to 300 train
# and 100 val clips (3 steps an epoch at batch 100) and 2 epochs.
TRAIN_CLIPS, VAL_CLIPS, CLIP_SECONDS = 300, 100, 10
TRAJECTORY_BAR = 2e-2  # the JAX package's loss-trajectory bar (test_torch_twin.py:158)


def write_corpus(root: str, train_clips: int = TRAIN_CLIPS, val_clips: int = VAL_CLIPS
                 ) -> tuple[str, str, str]:
    """Seeded PCM16 clips, each holding tones of 1-3 AudioSet classes (the
    class's own frequency), their datafile JSONs and the balanced-sampling
    weights (``gen_weight_file``). Returns (train json, val json, weights)."""
    label_csv = assets.label_csv_for("audioset")
    mids = [row["mid"] for row in load_label_csv(label_csv)]
    freqs = np.linspace(100.0, 7000.0, len(mids))
    rng = np.random.default_rng(9)
    t = np.arange(int(CLIP_SECONDS * SR)) / SR
    files = {}
    for split, count in (("train", train_clips), ("val", val_clips)):
        entries = []
        for i in range(count):
            classes = rng.choice(len(mids), size=rng.integers(1, 4), replace=False)
            x = 0.01 * rng.standard_normal(t.size)
            for c in classes:
                x += 0.25 * np.sin(2 * np.pi * freqs[c] * t + rng.uniform(0, 2 * np.pi))
            path = os.path.join(root, f"{split}_{i:04d}.wav")
            with open(path, "wb") as f:
                f.write(wav_bytes(x, SR))
            entries.append({"wav": path, "labels": ",".join(mids[c] for c in classes)})
        files[split] = os.path.join(root, f"{split}.json")
        save_datafile(files[split], entries)
    weights = gen_weight_file(files["train"], label_csv)
    return files["train"], files["val"], weights


class RecordingTrainer(Trainer):
    """The CLI's trainer, recording what each run sampled and drew: the
    train loader's indices by epoch, each step's draws (kept on the card,
    so the run adds no host sync), the fbank kernel's launch count when
    each epoch starts and when its validation ends, and the state a fresh
    run starts from (``initial``, on the host)."""

    runs: list = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.indices: dict[int, np.ndarray] = {}
        self.drawn: dict[int, torch.Tensor] = {}
        self.fbank_at: dict[tuple[str, int], int] = {}
        RecordingTrainer.runs.append(self)
        loader = self.train_loader
        epoch_indices, set_epoch = loader._epoch_indices, loader.set_epoch

        def recorded():
            idx = epoch_indices()
            self.indices[loader._epoch] = idx.copy()
            return idx

        def counted_set_epoch(epoch):
            self.fbank_at["start", epoch] = fbank_cuda.LAUNCHES
            set_epoch(epoch)

        loader._epoch_indices = recorded
        loader.set_epoch = counted_set_epoch

    def validate(self, state, loader, epoch, eval_target=False):
        out = super().validate(state, loader, epoch, eval_target)
        if loader is self.val_loader and isinstance(epoch, int):
            self.fbank_at["validated", epoch] = fbank_cuda.LAUNCHES
        return out

    def epoch_launches(self, epoch: int) -> int:
        """The fbank kernel's launches from the start of ``epoch`` to the
        end of its validation."""
        return self.fbank_at["validated", epoch] - self.fbank_at["start", epoch]

    def init_state(self):
        state = super().init_state()
        self.initial = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
        return state

    def draws(self, step, batch_size):
        d = super().draws(step, batch_size)
        parts = [d.pre.mixup.gate, d.pre.mixup.lam, *d.pre.freq, *d.pre.time]
        parts += [] if d.keep is None else [d.keep]
        self.drawn[step] = torch.cat([x.flatten().float() for x in parts])
        return d


def run_cli(argv: list[str]) -> RecordingTrainer:
    RecordingTrainer.runs.clear()
    cli.Trainer = RecordingTrainer
    try:
        cli.run(argv)
    finally:
        cli.Trainer = Trainer
    (trainer,) = RecordingTrainer.runs
    return trainer


def trace_summary(path: str) -> str:
    """The card's idle share over a profiled window, and where its
    host-to-card copies ran: stream, bytes, and the share of their time
    that kernels on other streams overlapped."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
           and e.get("dur")]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)

    def union(iv):
        out = []
        for a, b in sorted(iv):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    busy = sum(b - a for a, b in union(spans))
    window = spans[-1][1] - spans[0][0]
    kernels = [e for e in dev if e["cat"] == "kernel"]
    compute = max({e["args"].get("stream") for e in kernels},
                  key=lambda s: sum(e["dur"] for e in kernels if e["args"].get("stream") == s))
    h2d = [e for e in dev if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]]
    busy_k = union((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    overlap = sum(max(0.0, min(b, e["ts"] + e["dur"]) - max(a, e["ts"]))
                  for e in h2d for a, b in busy_k)
    copy_us = sum(e["dur"] for e in h2d)
    streams = sorted({e["args"].get("stream") for e in h2d}, key=str)
    kinds = sorted({e["name"] for e in h2d})
    nbytes = sum(e["args"].get("bytes", 0) for e in h2d)
    return (f"window {window / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, idle share "
            f"{1 - busy / window:.2%}; {len(kernels)} kernels, compute stream {compute}; "
            f"host-to-card copies: {len(h2d)} ({nbytes / 1e6:.1f} MB, {copy_us / 1e3:.2f} ms) "
            f"{kinds} on streams {streams}, {overlap / max(copy_us, 1e-9):.1%} of their time "
            f"under kernels")


def eval_batch_fbank(loader, pre: PreprocessConfig):
    """The fbank kernel against its plain version on the first batch of the
    protocol's eval loader (twice the train batch, its padded tail
    included), on the waveforms the eval step gives it."""
    from psla_tpu_torch.frontend import augment

    batches = iter(loader)
    try:
        batch = next(batches)
    finally:
        batches.close()
    wb = _wav_batch(batch, torch.device(DEVICE))
    wav = augment.dc_remove(wb.wav, wb.wav_mean, wb.length).contiguous()
    lengths, fc = wb.length.to(torch.int32), pre.fbank
    got = fbank_cuda.fbank_cuda(wav, lengths, fc, pre.target_length)
    want = fbank_cuda.fbank_plain(wav, lengths, fc, pre.target_length)
    err = float((got - want).abs().max())
    print(f"fbank on an eval batch [{wav.shape[0]}, {wav.shape[1]}] ({batch['n_valid']} valid "
          f"rows), max abs err vs plain {err:.3e} (bar {FBANK_ATOL})")
    check(got.shape == (wav.shape[0], pre.target_length, fc.num_mel_bins),
          f"fbank on the eval batch: shape {tuple(got.shape)}")
    check(err <= FBANK_ATOL, f"fbank on the eval batch: error {err}")


def trainer_phase(profile: bool, step_clips_s: float) -> tuple[int, int]:
    """psla-torch-train through ``cli.run`` at full width, then a resumed
    run held to the uninterrupted one. Returns the fbank kernel's launches
    in the first run and in its epoch 2 (train steps and validation)."""
    smi = card()
    root = tempfile.mkdtemp(prefix="psla_trainer_")
    try:
        t0 = time.perf_counter()
        train_json, val_json, weights = write_corpus(root)
        w = np.loadtxt(weights, delimiter=",")
        print(f"corpus: {TRAIN_CLIPS} train and {VAL_CLIPS} val clips of {CLIP_SECONDS} s "
              f"PCM16, 1-3 of {N_CLASS} classes each, written in "
              f"{time.perf_counter() - t0:.2f} s; balanced-sampling weights "
              f"{w.min():.1f}..{w.max():.1f}")
        base = ["--preset", "audioset_full", "--data-train", train_json, "--data-val",
                val_json, "--data-eval", val_json, "--label-csv",
                assets.label_csv_for("audioset"), "--impretrain", "False", "--warmup",
                "False", "--wa_start", "1", "--wa_end", "2", "--eff_b", str(EFF_B),
                "--target_length", str(TARGET), "-b", str(STEP_BATCH), "--device", DEVICE]

        # the decode rate of the train loader alone (primaries and mixup
        # partners), on this machine's cores
        loader = cli.make_loaders(cli.config_from_args(
            cli.build_parser().parse_args(base + ["--exp-dir", root])))[0]
        loader.set_epoch(1)
        t0 = time.perf_counter()
        n = sum(len(b["wav"]) + len(b["mix_wav"]) for b in loader)
        dt = time.perf_counter() - t0
        decoder = "native C++ (csrc/wavio.cc)" if native.available() else "numpy"
        print(f"loader alone: {n} clips decoded in {dt:.3f} s, {n / dt:.1f} clips/s, "
              f"decoder {decoder}, {loader.config.num_workers} workers, "
              f"{os.cpu_count()} CPUs ({len(os.sched_getaffinity(0))} usable), wire "
              f"{loader.config.wire} (host of the {smi})")

        # the main path: two epochs, validation, weight averaging, protocol
        exp = os.path.join(root, "exp")
        extra = ["--profile-steps", "3", "--profile-start-step", "3"] if profile else []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fbank_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        full = run_cli(base + ["--exp-dir", exp, "--n-epochs", "2"] + extra)
        torch.cuda.synchronize()
        launches = fbank_cuda.LAUNCHES
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        spe, vb = full.steps_per_epoch, full.val_loader.batches_per_epoch()
        eb = full.eval_loader.batches_per_epoch()
        # train steps, validate each epoch and wa, then the protocol: best and
        # wa on val and eval, each epoch checkpoint on eval
        want = 2 * spe + 2 * vb + vb + 2 * (vb + eb) + 2 * eb
        print(f"trainer run (cli.run, audioset_full: B{EFF_B}, {HEADS} heads, {N_CLASS} "
              f"classes, T={TARGET}, batch {STEP_BATCH}, float32, mixup 0.5, SpecAugment "
              f"48/192, bal, int16 wire, device_prefetch {full.config.device_prefetch}): "
              f"{spe} steps an epoch, 2 epochs, {wall:.2f} s in all; fbank launches "
              f"{launches} (train steps {2 * spe} + eval batches {want - 2 * spe})")
        check(launches == want, f"{launches} fbank launches, want {want}")
        per_epoch = full.epoch_launches(2)
        print(f"fbank launches in epoch 2, its train steps and validation: {per_epoch} "
              f"(train steps {spe} + val batches {vb})")
        check(per_epoch == spe + vb, f"{per_epoch} fbank launches in epoch 2, "
                                     f"want {spe + vb}")
        eval_batch_fbank(full.eval_loader, full.config.preprocess_config())
        result = np.loadtxt(os.path.join(exp, "result.csv"), delimiter=",")
        check(result.shape == (2, 10) and bool(np.all(np.isfinite(result))),
              f"result.csv {result}")
        for name in ("predictions/target.csv", "predictions/predictions_2.csv",
                     "predictions/ensemble_predictions.csv", "predictions/eval_target.csv",
                     "predictions/predictions_eval_1.csv", "predictions/predictions_eval_2.csv",
                     "models/epoch_1/checkpoint.pth", "models/epoch_2/checkpoint.pth",
                     "models/best/checkpoint.pth", "models/wa/checkpoint.pth",
                     "best_single_result.csv", "wa_result.csv", "ensemble_result.csv",
                     "stats_2.pickle", "progress.json"):
            check(os.path.exists(os.path.join(exp, name)), f"{name} not written")
        secs = full.train_seconds[2]
        m = full.meters
        print(f"trainer epoch 2: {spe * STEP_BATCH} clips in {secs:.3f} s of train loop, "
              f"{spe * STEP_BATCH / secs:.1f} clips/s (phase 6's bare step in this call: "
              f"{step_clips_s:.1f} clips/s); epoch 1 {full.train_seconds[1]:.3f} s; meters "
              f"per sample: data {m['per_sample_data_time'].avg * 1e3:.3f} ms, dnn "
              f"{m['per_sample_dnn_time'].avg * 1e3:.3f} ms, total "
              f"{m['per_sample_time'].avg * 1e3:.3f} ms; peak memory {peak / 2**30:.2f} GiB; "
              f"result.csv epoch 2: mAP {result[1, 0]:.4f}, train loss {result[1, 5]:.6f}, "
              f"valid loss {result[1, 6]:.6f} ({smi})")
        if profile:
            trace = os.path.join(exp, "profile", "trace_steps_3.json")
            print(f"trainer epoch 2 profiled (steps 3-5): {trace_summary(trace)} ({smi})")

        # the weight-averaged checkpoint serves
        names = make_name_dict(assets.label_csv_for("audioset"))
        model = create_model("efficientnet", label_dim=N_CLASS, eff_b=EFF_B, head_num=HEADS)
        model.load_state_dict(load_variables(os.path.join(exp, "models", "wa")))
        engine = InferenceEngine([model], PreprocessConfig(target_length=TARGET), names,
                                 batch_size=4, device=DEVICE)
        try:
            wav = decode_wav(open(os.path.join(root, "val_0000.wav"), "rb").read())[0]
            probs = engine.predict(wav, SR)
        finally:
            engine.close()
        check(probs.shape == (N_CLASS,) and bool(np.all(np.isfinite(probs))),
              "the wa checkpoint served non-finite probabilities")
        print(f"wa checkpoint served: probabilities {probs.min():.4f}..{probs.max():.4f}")

        # resume: one epoch, then the second with --resume
        exp2 = os.path.join(root, "exp_resumed")
        first = run_cli(base + ["--exp-dir", exp2, "--n-epochs", "1"])
        second = run_cli(base + ["--exp-dir", exp2, "--n-epochs", "2", "--resume"])
        for epoch, run in ((1, first), (2, second)):
            check(np.array_equal(full.indices[epoch], run.indices[epoch]),
                  f"epoch {epoch}: the resumed run sampled other clips")
        steps = sorted(full.drawn)
        resumed = {**first.drawn, **second.drawn}
        check(sorted(resumed) == steps, f"steps {sorted(resumed)} against {steps}")
        for step in steps:
            check(torch.equal(full.drawn[step], resumed[step]), f"step {step}: other draws")
        res2 = np.loadtxt(os.path.join(exp2, "result.csv"), delimiter=",")
        diffs = np.abs(res2[1, 5:7] - result[1, 5:7])
        print(f"resume: sampled indices of both epochs and the draws of steps "
              f"{steps[0]}-{steps[-1]} equal to the uninterrupted run's; epoch 2 train loss "
              f"{result[1, 5]:.6f} vs resumed {res2[1, 5]:.6f}, valid loss "
              f"{result[1, 6]:.6f} vs resumed {res2[1, 6]:.6f}: max diff {diffs.max():.3e} "
              f"(bar {TRAJECTORY_BAR}), bit-equal: {bool(np.all(diffs == 0))}")
        check(diffs.max() <= TRAJECTORY_BAR, f"resumed losses off by {diffs.max()}")
        return launches, per_epoch
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------- phase 8

# The eval side at audioset_full width on phase 7's corpus writer: 100 tone
# clips of 10 s, eval batch 32 (4 batches, the last with 4 clips and 28
# padded rows), 3 seeded members.
EVAL_CLIPS, EVAL_BATCH = 100, 32
EVAL_SEEDS = (21, 22, 23)
ENSEMBLE_ATOL = 1e-5  # stacked vs sequential predictions
WA_ATOL = 1e-6  # the averaged state vs the float64 mean of the members
NORM_ATOL = 2e-4  # compute_stats' mean and std, kernel vs plain fbank (the fbank bar)
PREDICT_ATOL = 1e-4  # predict_long's bar
PREDICT_SECONDS = 60
EXPORT_MEMBERS = 2
EXPORT_ATOL = 1e-6  # the artifact vs the live program it was traced from (export_chipcheck)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# Runs exported artifacts with torch alone (no module of this repo): a copy
# of what a serving host does. Arguments: the inputs' .npz, the output
# directory, --profile or -, then (name, artifact) pairs. Prints one JSON
# line.
BARE_EXPORT = r"""
import json, sys, time
import numpy as np, torch
from torch.export.passes import move_to_device_pass
cuda = torch.device("cuda")
x = np.load(sys.argv[1])
out_dir, profile = sys.argv[2], sys.argv[3] == "--profile"
loaded = {}
for name, path in zip(sys.argv[4::2], sys.argv[5::2]):
    program = move_to_device_pass(torch.export.load(path), cuda)
    loaded[name] = (program.graph_module.code, {**program.state_dict, **program.constants},
                    program.module())
def call(module):
    args = [torch.from_numpy(x[k]).to(cuda) for k in ("wav", "mean", "lengths")]
    with torch.no_grad():
        return module(*args).cpu().numpy()
for name, (_, _, module) in loaded.items():  # PyTorch's default flags: cuDNN's TF32
    np.save(f"{out_dir}/{name}_tf32.npy", call(module))
torch.backends.cudnn.allow_tf32 = False  # float32 convolutions, as the live engine's
torch.backends.cuda.matmul.allow_tf32 = False
result = {}
for name, (code, held, module) in loaded.items():
    for _ in range(2):
        out = call(module)
    t0 = time.perf_counter()
    for _ in range(10):
        out = call(module)
    ms = (time.perf_counter() - t0) / 10 * 1e3
    np.save(f"{out_dir}/{name}.npy", out)
    if profile:  # device time by kernel over one call
        from torch.profiler import ProfilerActivity, profile as trace
        with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call(module)
        print(name, "artifact")
        print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=15))
    result[name] = {
        "ms": ms, "cpu_literals": code.count("type='cpu'"),
        "tensors_off_card": sorted(k for k, v in held.items() if v.device.type != "cuda"),
        "dtypes": sorted({str(v.dtype) for v in held.values()})}
result["repo_modules"] = sorted(m for m in sys.modules if m.split(".")[0].startswith("psla_tpu"))
print(json.dumps(result))
"""


def imagenet_layout(sd: dict, seed: int = 31) -> dict:
    """A port B2 state_dict laid out as efficientnet_pytorch's ImageNet
    file: no pooling head, no ``effnet.`` prefix, a seeded 3-channel stem,
    and an ``_fc`` classifier."""
    rng = np.random.default_rng(seed)
    out = {k[len("effnet."):]: v for k, v in sd.items() if k.startswith("effnet.")}
    stem = out["_conv_stem.weight"]
    out["_conv_stem.weight"] = torch.from_numpy(
        rng.normal(0.0, 0.3, (stem.shape[0], 3, *stem.shape[2:])).astype(np.float32))
    out["_fc.weight"] = torch.zeros(1000, out["_bn1.weight"].shape[0])
    out["_fc.bias"] = torch.zeros(1000)
    return out


def timed_tool(fn):
    """(result, seconds, fbank launches, peak memory) of one tool run: the
    launch count set to 0 just before, read just after."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fbank_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, fbank_cuda.LAUNCHES, torch.cuda.max_memory_allocated()


def eval_phase(profile: bool) -> tuple[int, dict]:
    """The eval tools through their entry points at full width; returns the
    fbank kernel's launches in them and the phase's numbers. ``profile``
    adds the device time by kernel of one artifact call and one live
    engine call."""
    smi = card()
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="psla_eval_")
    launches = 0
    numbers = {}
    try:
        label_csv = assets.label_csv_for("audioset")
        eval_json = write_corpus(root, train_clips=EVAL_CLIPS, val_clips=0)[0]
        sds = [seeded_state_dict(s) for s in EVAL_SEEDS]
        paths = []
        for i, sd in enumerate(sds):
            path = os.path.join(root, f"member_{i}.pth")
            if i == 0:  # a reference checkpoint: DataParallel prefixes and an _fc
                sd = {**{f"module.{k}": v for k, v in sd.items()},
                      "module.effnet._fc.weight": torch.zeros(N_CLASS, 1408)}
            torch.save(sd, path)
            paths.append(path)
        n_batches = -(-EVAL_CLIPS // EVAL_BATCH)
        target = load_datafile(eval_json, label_csv).label_matrix()

        # the checkpoint ensemble: stacked (default) and --sequential
        width = ["--eff_b", str(EFF_B), "--target_length", str(TARGET)]
        argv = paths + ["--data-eval", eval_json, "--label-csv", label_csv, "--preset",
                        "audioset_full", "--batch-size", str(EVAL_BATCH), "--device",
                        DEVICE] + width
        preds, runs = {}, {}
        # in turns, so drift on the card touches both alike
        for k, (mode, extra) in enumerate((("stacked", []), ("sequential", ["--sequential"]),
                                           ("sequential", ["--sequential"]),
                                           ("stacked", []))):
            out = os.path.join(root, f"{mode}_{k}")
            rc, secs, n, peak = timed_tool(
                lambda: ensemble_tool.main(argv + ["--out-dir", out] + extra))
            check(rc == 0, f"ensemble {mode}: exit {rc}")
            got = np.stack([np.loadtxt(os.path.join(out, f"predictions_{i}.csv"),
                                       delimiter=",") for i in range(len(paths))])
            got_target = np.loadtxt(os.path.join(out, "target.csv"), delimiter=",")
            check(got.shape == (len(paths), EVAL_CLIPS, N_CLASS)
                  and bool(np.all(np.isfinite(got))),
                  f"ensemble {mode}: predictions {got.shape}")
            check(np.array_equal(got_target, target), f"ensemble {mode}: target.csv order")
            preds.setdefault(mode, got)
            runs.setdefault(mode, []).append((secs, n, peak))
            launches += n
        err = float(np.abs(preds["stacked"] - preds["sequential"]).max())
        maps = [ensemble_tool.scores(p.astype(np.float32), target)[0]
                for p in preds["stacked"]]
        for mode, rs in runs.items():
            secs = [r[0] for r in rs]
            print(f"ensemble {mode} (tools/ensemble.main, {len(paths)} B{EFF_B} members, "
                  f"{EVAL_CLIPS} clips of {CLIP_SECONDS} s, batch {EVAL_BATCH}): "
                  f"{np.mean(secs):.3f} s {[round(x, 3) for x in secs]}, "
                  f"{EVAL_CLIPS / np.mean(secs):.1f} clips/s, fbank launches "
                  f"{[r[1] for r in rs]}, peak memory "
                  f"{max(r[2] for r in rs) / 2**30:.2f} GiB ({smi})")
            numbers[f"ensemble_{mode}_clips_s"] = EVAL_CLIPS / np.mean(secs)
            want = n_batches * (1 if mode == "stacked" else len(paths))
            check(all(r[1] == want for r in rs),
                  f"{mode} ensemble: fbank launches {[r[1] for r in rs]}, want {want}")
        print(f"ensemble: stacked vs sequential predictions max abs {err:.3e} (bar "
              f"{ENSEMBLE_ATOL}); members' mAP {[round(m, 4) for m in maps]}")
        check(err <= ENSEMBLE_ATOL, f"stacked vs sequential: {err}")
        check(all(np.isfinite(maps)), f"members' mAP {maps}")

        # the passes alone, models built and on the card: one stacked pass
        # against one pass a member
        pre = PreprocessConfig(target_length=TARGET).eval_variant()
        loader = AudioLoader(load_datafile(eval_json, label_csv),
                             LoaderConfig(batch_size=EVAL_BATCH,
                                          buffer_samples=pre.fbank.buffer_length(TARGET),
                                          drop_remainder=False), shuffle=False)
        models = [member(sd, torch.float32).to(DEVICE) for sd in sds]
        passes = {"stacked": [], "sequential": []}
        for mode in ("stacked", "sequential", "sequential", "stacked"):
            if mode == "stacked":
                fn = lambda: ensemble_tool.predict_stacked(  # noqa: E731
                    models, loader, pre, DEVICE)
            else:
                fn = lambda: [ensemble_tool.predict(m, loader, pre, DEVICE)  # noqa: E731
                              for m in models]
            _, secs, n, _ = timed_tool(fn)
            passes[mode].append(secs)
            launches += n
            want = n_batches * (1 if mode == "stacked" else len(models))
            check(n == want, f"{mode} passes: {n} fbank launches, want {want}")
        for mode, secs in passes.items():
            numbers[f"ensemble_{mode}_pass_clips_s"] = EVAL_CLIPS / np.mean(secs)
            print(f"ensemble {mode} passes alone ({len(models)} members on the card): "
                  f"{np.mean(secs):.3f} s {[round(x, 3) for x in secs]}, "
                  f"{EVAL_CLIPS / np.mean(secs):.1f} clips/s ({smi})")
        del models

        # weight averaging of the three members, then its eval
        res, secs, n, _ = timed_tool(lambda: wa_tool.weight_average_eval(
            paths, loader, pre, n_class=N_CLASS, eff_b=EFF_B, device=DEVICE))
        launches += n
        plain = [load_variables(p) for p in paths]
        wa_err = max(float(np.abs(res["state_dict"][k].double().numpy() - np.mean(
            [sd[k].double().numpy() for sd in plain], axis=0)).max()) for k in plain[0])
        print(f"weight averaging of {len(paths)} members: max abs vs the float64 mean "
              f"{wa_err:.3e} (bar {WA_ATOL}); eval {secs:.3f} s, mAP {res['mAP']:.4f}, "
              f"fbank launches {n}")
        check(wa_err <= WA_ATOL, f"averaged state off the float64 mean by {wa_err}")
        check(bool(np.isfinite(res["mAP"])), f"weight-averaged mAP {res['mAP']}")
        check(n == n_batches, f"weight averaging: {n} fbank launches, want {n_batches}")

        # compute_stats through the kernel, against the plain fbank on the card
        (mean, std), secs, n, _ = timed_tool(lambda: stats_tool.compute_norm_stats(
            eval_json, label_csv, target_length=TARGET, device=DEVICE))
        launches += n
        pmean, pstd = stats_tool.compute_norm_stats(eval_json, label_csv, target_length=TARGET,
                                                   fbank_method="fft64", device=DEVICE)
        stats_err = max(abs(mean - pmean), abs(std - pstd))
        numbers["compute_stats_clips_s"] = EVAL_CLIPS / secs
        print(f"compute_stats: mean {mean:.6f} std {std:.6f} (plain fbank {pmean:.6f} "
              f"{pstd:.6f}, max abs {stats_err:.3e}, bar {NORM_ATOL}); {secs:.3f} s, "
              f"{EVAL_CLIPS / secs:.1f} clips/s, fbank launches {n} ({smi})")
        check(stats_err <= NORM_ATOL, f"compute_stats kernel vs plain: {stats_err}")
        check(n == -(-EVAL_CLIPS // 32), f"compute_stats: {n} fbank launches")

        # psla-torch-predict on a 60 s clip
        clip_path = os.path.join(root, "long60s.wav")
        with open(clip_path, "wb") as f:
            f.write(wav_bytes(tones(np.random.default_rng(13), PREDICT_SECONDS * SR), SR))
        got, secs, n, _ = timed_tool(lambda: predict_tool.run(
            [clip_path, "--ckpt", paths[1], "--label-csv", label_csv, "--device", DEVICE]
            + width))
        launches += n
        wav = decode_wav(open(clip_path, "rb").read())[0]
        model = member(sds[1], torch.float32).to(DEVICE)
        want = predict_long(model, wav, dataclasses.replace(
            PreprocessConfig(target_length=TARGET), fbank_method="fft64"), device=DEVICE)
        t0 = time.perf_counter()
        predict_long(model, wav, PreprocessConfig(target_length=TARGET), device=DEVICE)
        long_s = time.perf_counter() - t0
        pred_err = float(np.abs(got[clip_path] - want).max())
        chunk = PreprocessConfig(target_length=TARGET).fbank.buffer_length(TARGET)
        chunks = -(-wav.size // chunk)
        numbers["predict_s_per_60s"] = secs
        print(f"psla-torch-predict, {PREDICT_SECONDS} s clip ({chunks} chunks): {secs:.3f} s "
              f"through main (model load included), predict_long alone {long_s:.3f} s; "
              f"max abs vs the plain fbank {pred_err:.3e} (bar {PREDICT_ATOL}); fbank "
              f"launches {n} ({smi})")
        check(pred_err <= PREDICT_ATOL, f"predict vs plain predict_long: {pred_err}")
        check(n == -(-chunks // 8), f"predict: {n} fbank launches")

        # the torch.export artifacts of a 2-member ensemble, bf16 (the CLI's
        # default) and float32, loaded by torch alone
        ckpts = [a for p in paths[:EXPORT_MEMBERS] for a in ("--ckpt", p)]
        arts, export_s = {}, {}
        for dtype in DTYPES:
            arts[dtype] = os.path.join(root, f"export_{dtype}")
            extra = [] if dtype == "bfloat16" else ["--dtype", dtype]
            rc, export_s[dtype], _, _ = timed_tool(lambda: export_tool.main(
                ckpts + ["--out", arts[dtype], "--device", DEVICE] + width + extra))
            check(rc == 0, f"export {dtype}: exit {rc}")
            with open(os.path.join(arts[dtype], export_tool.META)) as f:
                got_dtype = json.load(f)["model"]["dtype"]
            check(got_dtype == dtype, f"export {extra}: meta.json says {got_dtype}")
        rng = np.random.default_rng(17)
        x = np.stack([tones(rng, chunk) for _ in range(BATCH)])
        lengths = np.full(BATCH, chunk, np.int32)
        lengths[1], lengths[2] = chunk // 3, 5 * SR
        for i in (1, 2):
            x[i, lengths[i]:] = 0.0
        xmean = (x.sum(axis=1) / lengths).astype(np.float32)
        np.savez(os.path.join(root, "in.npz"), wav=x, mean=xmean, lengths=lengths)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", BARE_EXPORT, os.path.join(root, "in.npz"), root,
             "--profile" if profile else "-"]
            + [a for dtype in DTYPES for a in (dtype, os.path.join(arts[dtype],
                                                                   export_tool.ARTIFACT))],
            cwd=root, env=env, capture_output=True, text=True, timeout=600)
        bare_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"bare torch load: {proc.stdout[-2000:]} "
                                    f"{proc.stderr[-4000:]}")
        bare = json.loads(proc.stdout.strip().splitlines()[-1])
        if profile:
            print("\n".join(proc.stdout.strip().splitlines()[:-1]))
        names = make_name_dict(label_csv)
        live, live_ms = {}, {}
        for dtype, torch_dtype in DTYPES.items():
            fbank_cuda.LAUNCHES = 0
            engine = InferenceEngine([member(sd, torch_dtype) for sd in sds[:EXPORT_MEMBERS]],
                                     PreprocessConfig(target_length=TARGET), names,
                                     batch_size=BATCH, device=DEVICE)
            try:
                live[dtype] = engine.batch_probs(x, xmean, lengths)
                for _ in range(2):
                    engine.batch_probs(x, xmean, lengths)
                t0 = time.perf_counter()
                for _ in range(10):
                    engine.batch_probs(x, xmean, lengths)
                live_ms[dtype] = (time.perf_counter() - t0) / 10 * 1e3
                if profile:
                    profile_dispatch(engine)
            finally:
                engine.close()
            launches += fbank_cuda.LAUNCHES
        # the live bf16 program the artifact was traced from ('gemm'), eager
        program = export_tool.build_program(
            [member(sd, torch.bfloat16) for sd in sds[:EXPORT_MEMBERS]],
            PreprocessConfig(target_length=TARGET), DEVICE)
        with torch.no_grad():
            gemm16 = program(*(torch.from_numpy(a).to(DEVICE)
                               for a in (x, xmean, lengths))).cpu().numpy()
        del program
        out = {d: np.load(os.path.join(root, f"{d}.npy")) for d in DTYPES}
        f32_err = float(np.abs(out["float32"] - live["float32"]).max())
        tf32_err = float(np.abs(np.load(os.path.join(root, "float32_tf32.npy"))
                                - live["float32"]).max())
        bf16_err = float(np.abs(out["bfloat16"] - gemm16).max())
        bf16_live_err = float(np.abs(out["bfloat16"] - live["bfloat16"]).max())
        bf16_tf32_err = float(np.abs(np.load(os.path.join(root, "bfloat16_tf32.npy"))
                                     - out["bfloat16"]).max())
        sizes = {d: os.path.getsize(os.path.join(arts[d], export_tool.ARTIFACT)) / 1e6
                 for d in DTYPES}
        numbers.update(export_ms=bare["float32"]["ms"], live_ms=live_ms["float32"],
                       export_bf16_ms=bare["bfloat16"]["ms"], live_bf16_ms=live_ms["bfloat16"])
        print(f"export ({EXPORT_MEMBERS} B{EFF_B} members, symbolic batch, traced on "
              f"{DEVICE}): bfloat16 {export_s['bfloat16']:.2f} s, {sizes['bfloat16']:.1f} MB "
              f"(held {bare['bfloat16']['dtypes']}); float32 {export_s['float32']:.2f} s, "
              f"{sizes['float32']:.1f} MB; loaded by torch alone in a subprocess "
              f"({bare_s:.2f} s; modules of this repo imported: {bare['repo_modules']}; cpu "
              f"device literals in the graphs: "
              f"{[bare[d]['cpu_literals'] for d in DTYPES]}; tensors off the card: "
              f"{[bare[d]['tensors_off_card'] for d in DTYPES]}) ({smi})")
        print(f"  batch {BATCH}, a call (host clock, waveforms in, probabilities out): "
              f"bf16 artifact ('gemm' fbank) {bare['bfloat16']['ms']:.2f} ms, live bf16 "
              f"engine (fbank kernel) {live_ms['bfloat16']:.2f} ms; float32 artifact "
              f"{bare['float32']['ms']:.2f} ms, live float32 engine "
              f"{live_ms['float32']:.2f} ms")
        print(f"  bf16 artifact vs the live bf16 program ('gemm') max abs {bf16_err:.3e} "
              f"(bar {EXPORT_ATOL}), vs the live bf16 engine (fbank kernel) "
              f"{bf16_live_err:.3e} (not held), with cuDNN's default TF32 flags "
              f"{bf16_tf32_err:.3e} from itself; float32 artifact vs the live float32 "
              f"engine {f32_err:.3e} (bar {SERVE_ATOL}), with cuDNN's default TF32 "
              f"convolutions {tf32_err:.3e} (not held)")
        for d in DTYPES:
            check(bare[d]["cpu_literals"] == 0 and not bare[d]["tensors_off_card"],
                  f"the moved {d} program keeps the CPU: {bare[d]['cpu_literals']} "
                  f"literals, {bare[d]['tensors_off_card']}")
        check(not bare["repo_modules"],
              f"the artifacts' loader imported {bare['repo_modules']}")
        check("torch.bfloat16" in bare["bfloat16"]["dtypes"],
              f"the bf16 artifact holds {bare['bfloat16']['dtypes']}")
        check(bf16_err <= EXPORT_ATOL, f"bf16 artifact vs live bf16 program: {bf16_err}")
        check(f32_err <= SERVE_ATOL, f"artifact vs live engine: {f32_err}")

        # psla-torch-export-chipcheck at its defaults, as a deployer runs it
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "psla_tpu_torch.tools.export_chipcheck"],
                              cwd=os.path.dirname(os.path.abspath(__file__)),
                              capture_output=True, text=True, timeout=600)
        chipcheck_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"export_chipcheck: exit {proc.returncode} "
                                    f"{proc.stdout[-2000:]} {proc.stderr[-4000:]}")
        verdict = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"psla-torch-export-chipcheck at its defaults ({chipcheck_s:.1f} s): "
              f"{json.dumps(verdict)}")
        check(verdict["ok"] is True and verdict["backend"] == "cuda",
              f"export_chipcheck: {verdict}")

        # impretrain: the ImageNet backbone through the environment variable
        imagenet = imagenet_layout(sds[2])
        im_path = os.path.join(root, "efficientnet-b2-seeded.pth")
        torch.save(imagenet, im_path)
        before = os.environ.get(CKPT_ENV)
        os.environ[CKPT_ENV] = im_path
        try:
            cfg = cli.config_from_args(cli.build_parser().parse_args(
                ["--preset", "audioset_full", "--data-train", eval_json, "--data-val",
                 eval_json, "--label-csv", label_csv, "--exp-dir",
                 os.path.join(root, "imagenet"), "--device", DEVICE] + width))
            check(cfg.impretrain, "impretrain is not the preset's default")
            train_loader, val_loader, _ = cli.make_loaders(cfg)
            state = Trainer(cfg, train_loader, val_loader, device=DEVICE).init_state()
        finally:
            if before is None:
                os.environ.pop(CKPT_ENV)
            else:
                os.environ[CKPT_ENV] = before
        got = {k: v.cpu() for k, v in state.model.state_dict().items()}
        stem = imagenet["_conv_stem.weight"].sum(1, keepdim=True)
        stem_err = float((got["effnet._conv_stem.weight"] - stem).abs().max())
        print(f"impretrain: Trainer.init_state on {DEVICE} from {CKPT_ENV}: stem "
              f"{tuple(got['effnet._conv_stem.weight'].shape)}, max abs vs the RGB sum "
              f"{stem_err:.3e}")
        check(stem_err <= 1e-6 * float(stem.abs().max()), f"stem off the RGB sum: {stem_err}")
        check(torch.equal(got["effnet._bn0.running_mean"], imagenet["_bn0.running_mean"]),
              "_bn0's running mean is not the file's")
        numbers["phase_s"] = time.perf_counter() - t_phase
        print(f"phase 8: {numbers['phase_s']:.1f} s; fbank launches in its tool runs "
              f"{launches}")
        return launches, numbers
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------- phase 9

# The FSD50K recipe (psla_tpu_torch/config.py:161-165; the reference's
# egs/fsd50k/run.sh): EffNet-B2, 4 heads, 200 classes, T=3000, 128 mels,
# batch 24, lr 5e-4, mixup 0.5, SpecAugment 48/192. The corpus is cut to 96
# dev clips (72 train, 24 val) and 48 eval clips (FSD50K: 40,966 dev, of
# them 36,796 train, and 10,231 eval) of 0.3-30 s at the release's 44.1 kHz.
FSD = from_preset("fsd50k")
FSD_TRAIN, FSD_VAL, FSD_EVAL = 72, 24, 48
FSD_RATE, FSD_SECONDS = 44100, (0.3, 30.0)
FSD_STEPS_PER_EPOCH = 36_796 // 24  # the schedule's epoch: FSD50K's train split
RESAMPLE_STEPS = 1  # PCM16 steps: the native resampler vs data/wav.resample
RELEASE_SEED = 31
# (g): flagship.run at audioset_full width (B2, T=1056, batch 128), cut
# from the tool's 1024 train and 256 val clips
FLAGSHIP_CLIPS, FLAGSHIP_VAL_CLIPS, FLAGSHIP_EPOCHS = 512, 128, 3


def write_fsd_root(root: str, seed: int = 19) -> dict[str, list[tuple[str, str]]]:
    """An FSD50K-layout release root: ``FSD50K.ground_truth/{dev,eval}.csv``
    (fname, labels, mids[, split]) and ``FSD50K.{dev,eval}_audio/`` of
    44.1 kHz PCM16 clips, each 0.3-30 s of tones of 1-3 of the 200
    classes (the class's own frequency) over noise, drawn with numpy from
    ``seed``. Returns each split's (fname, mids) rows."""
    labels = load_label_csv(assets.fsd50k_label_csv())
    freqs = np.geomspace(60.0, 16000.0, len(labels))
    rng = np.random.default_rng(seed)
    gt = os.path.join(root, "FSD50K.ground_truth")
    os.makedirs(gt)
    rows: dict[str, list[tuple[str, str]]] = {}
    for split, count in (("dev", FSD_TRAIN + FSD_VAL), ("eval", FSD_EVAL)):
        audio = os.path.join(root, f"FSD50K.{split}_audio")
        os.makedirs(audio)
        rows[split] = []
        for i in range(count):
            n = int(rng.uniform(*FSD_SECONDS) * FSD_RATE)
            t = np.arange(n) / FSD_RATE
            classes = rng.choice(len(labels), size=rng.integers(1, 4), replace=False)
            x = 0.02 * rng.standard_normal(n)
            for c in classes:
                x += 0.25 * np.sin(2 * np.pi * freqs[c] * t + rng.uniform(0, 2 * np.pi))
            fname = str(100_000 * (split == "eval") + 1000 + i)
            write_wav(os.path.join(audio, f"{fname}.wav"), x, FSD_RATE)
            rows[split].append((fname, ",".join(labels[c]["mid"] for c in classes)))
    for split, header in (("dev", ["fname", "labels", "mids", "split"]),
                          ("eval", ["fname", "labels", "mids"])):
        with open(os.path.join(gt, f"{split}.csv"), "w", newline="") as f:
            out = csv.writer(f)
            out.writerow(header)
            for i, (fname, mids) in enumerate(rows[split]):
                names = ",".join(next(r["display_name"] for r in labels if r["mid"] == m)
                                 for m in mids.split(","))
                extra = ["train" if i < FSD_TRAIN else "val"] if split == "dev" else []
                out.writerow([fname, names, mids, *extra])
    return rows


def pcm16_of(path: str) -> np.ndarray:
    return np.round(read_wav(path)[0].astype(np.float64) * 32768.0).astype(np.int64)


def fsd_prep(root: str) -> dict[str, str]:
    """(a) ``prep_fsd`` on a seeded FSD50K-layout root: both audio folders
    through ``resample_dir`` (the native resampler must take every file),
    three outputs held to ``wav.resample``, then ``build_datafiles``, whose
    datafiles must hold the CSVs' rows in order and whose weight file must
    be the balanced sampler's weights. Returns the datafile paths by name."""
    t0 = time.perf_counter()
    rows = write_fsd_root(root)
    label_csv = assets.fsd50k_label_csv()
    seconds = {s: sum(os.path.getsize(os.path.join(root, f"FSD50K.{s}_audio", f"{f}.wav")) - 44
                      for f, _ in rows[s]) / 2 / FSD_RATE for s in rows}
    print(f"fsd50k root: {len(rows['dev'])} dev ({FSD_TRAIN} train, {FSD_VAL} val) and "
          f"{len(rows['eval'])} eval clips at {FSD_RATE} Hz, {seconds['dev']:.1f} + "
          f"{seconds['eval']:.1f} s of audio, written in {time.perf_counter() - t0:.2f} s")
    check(native.available(), "the native resampler (csrc/resample.cc) did not build")
    out16 = {s: os.path.join(root, f"FSD50K.{s}_audio_16k") for s in rows}
    t0 = time.perf_counter()
    leftover = {s: prep_fsd.resample_dir(os.path.join(root, f"FSD50K.{s}_audio"), out16[s])
                for s in rows}
    secs = time.perf_counter() - t0
    check(leftover == {"dev": 0, "eval": 0}, f"files left to the per-file path: {leftover}")
    errs = []
    for split, i in (("dev", 0), ("dev", -1), ("eval", 0)):
        fname = rows[split][i][0]
        x, sr = read_wav(os.path.join(root, f"FSD50K.{split}_audio", f"{fname}.wav"))
        want = np.round(np.clip(resample(x, sr, 16000), -1.0, 1.0).astype(np.float64)
                        * 32767.0).astype(np.int64)
        got = pcm16_of(os.path.join(out16[split], f"{fname}.wav"))
        check(got.shape == want.shape, f"{fname}: {got.shape} samples, want {want.shape}")
        errs.append(int(np.abs(got - want).max()))
    print(f"prep_fsd.resample_dir: {sum(len(r) for r in rows.values())} files to 16 kHz in "
          f"{secs:.2f} s ({sum(seconds.values()) / secs:.0f}x real time on "
          f"{len(os.sched_getaffinity(0))} cores), 0 via the per-file fallback; "
          f"three outputs vs wav.resample: max {errs} PCM16 steps (bar {RESAMPLE_STEPS})")
    check(max(errs) <= RESAMPLE_STEPS, f"native resampler vs wav.resample: {errs} steps")

    paths = prep_fsd.build_datafiles(root, os.path.join(root, "datafiles"), out16["dev"],
                                     out16["eval"], label_csv)
    splits = {"fsd50k_tr_full": ("dev", slice(0, FSD_TRAIN)),
              "fsd50k_val_full": ("dev", slice(FSD_TRAIN, None)),
              "fsd50k_eval_full": ("eval", slice(None))}
    for name, (split, part) in splits.items():
        with open(paths[name]) as f:
            data = json.load(f)["data"]
        want = [{"wav": os.path.join(out16[split], f"{fname}.wav"), "labels": mids}
                for fname, mids in rows[split][part]]
        check(data == want, f"{name}: the datafile is not the CSV's rows")
    weights = np.loadtxt(paths["fsd50k_tr_full"][:-5] + "_weight.csv", delimiter=",")
    want = compute_sample_weights(load_datafile(paths["fsd50k_tr_full"], label_csv))
    check(np.array_equal(weights, want), "the weight file is not the sampler's weights")
    print(f"prep_fsd.build_datafiles: train {FSD_TRAIN}, val {FSD_VAL}, eval {FSD_EVAL} "
          f"entries equal to the CSVs' rows; weight file equal to compute_sample_weights "
          f"({weights.min():.1f}..{weights.max():.1f})")
    return paths


def fsd_fbank(eval_json: str) -> dict:
    """(b) The fbank kernel at the fsd50k eval shape: the first eval batch
    as the eval step gives it (decoded 16 kHz clips, DC removed, in a
    [24, 480240] buffer with their ragged lengths) -> [24, 3000, 128]. One
    launch counted, held to the plain version ('fft64'), then timed beside
    it, the library yardsticks and its bound."""
    from psla_tpu_torch.frontend import augment

    pre = FSD.preprocess_config().eval_variant()
    fc, target = pre.fbank, pre.target_length
    loader = AudioLoader(load_datafile(eval_json, assets.fsd50k_label_csv()),
                         LoaderConfig(batch_size=FSD.batch_size,
                                      buffer_samples=fc.buffer_length(target),
                                      drop_remainder=False), shuffle=False)
    batches = iter(loader)
    try:
        batch = next(batches)
    finally:
        batches.close()
    wb = _wav_batch(batch, torch.device(DEVICE))
    wav = augment.dc_remove(wb.wav, wb.wav_mean, wb.length).contiguous()
    lengths = wb.length.to(torch.int32)
    n = wav.shape[1]
    check(wav.shape == (FSD.batch_size, fc.buffer_length(target)), f"eval batch {wav.shape}")
    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    got = fbank_cuda.fbank_cuda(wav, lengths, fc, target)
    torch.cuda.synchronize()
    launches = fbank_cuda.LAUNCHES
    want = fbank_cuda.fbank_plain(wav, lengths, fc, target)
    err = float((got - want).abs().max())
    check(launches == 1, f"{launches} fbank launches for one fsd50k batch")
    check(got.shape == (FSD.batch_size, target, fc.num_mel_bins), f"shape {tuple(got.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite log-mel at the fsd50k shape")
    check(err <= FBANK_ATOL, f"fbank at the fsd50k shape: error {err}")

    frames = wav.unfold(-1, fc.window_size, fc.window_shift)[:, :target]
    frames = frames.reshape(-1, fc.window_size).contiguous()
    a = torch.from_numpy(frontend_matrix(fc)).to(DEVICE)
    fns = {"kernel": lambda: fbank_cuda.fbank_cuda(wav, lengths, fc, target),
           "plain": lambda: fbank_cuda.fbank_plain(wav, lengths, fc, target),
           "library": lambda: torch.matmul(frames, a),
           "rfft": lambda: torch.fft.rfft(frames, n=fc.padded_window_size)}
    times: dict[str, list[float]] = {}
    for name in ("plain", "kernel", "library", "rfft", "rfft", "library", "kernel", "plain"):
        times.setdefault(name, []).append(cuda_ms(fns[name], reps=10))
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    lens = lengths.cpu().numpy()
    bound = fbank_bound(fc, lens, n, target)
    full = fbank_bound(fc, np.full(len(lens), n), n, target)
    print(f"fbank at the fsd50k eval shape [{len(lens)}, {n}] -> [{len(lens)}, {target}, "
          f"{fc.num_mel_bins}] (clips {lens.min() / SR:.2f}-{lens.max() / SR:.2f} s, "
          f"{bound['frames']} of {len(lens) * target} frames valid): launches {launches}, "
          f"max abs err vs plain ('fft64') {err:.3e} (bar {FBANK_ATOL}); kernel "
          f"{ms['kernel']:.4f} ms {times['kernel']}, plain {ms['plain']:.4f} ms, library "
          f"(cuBLAS f32 frames[{frames.shape[0]},{frames.shape[1]}] @ A) {ms['library']:.4f} "
          f"ms, cuFFT rfft {ms['rfft']:.4f} ms; bound {bound['ms']:.4f} ms ({bound['by']}: "
          f"{bound['bytes'] / 1e6:.3f} MB, {bound['flop'] / 1e9:.4f} GFLOP), kernel at "
          f"{bound['ms'] / ms['kernel']:.1%} of it; at full lengths the bound would be "
          f"{full['ms']:.4f} ms ({full['by']}: {full['bytes'] / 1e6:.3f} MB)")
    return {"ms": ms["kernel"], "plain_ms": ms["plain"], "library_ms": ms["library"],
            "bound_ms": bound["ms"], "bound_by": bound["by"], "max_abs_err": err,
            "launches": launches}


def fsd_train_step() -> tuple[float, float]:
    """(c) The fsd50k train step at full width, held to the plain fbank's
    step at phase 6's bars, then timed. Returns (clips/s, device ms)."""
    cfg = FSD.preprocess_config()
    batch = train_batch(cfg, seed=23, batch=FSD.batch_size, n_class=FSD.n_class)
    sd = seeded_state_dict(SEEDS[0], n_class=FSD.n_class)
    state, _, _, step, gen, _, _ = step_held_to_plain(
        cfg, batch, lambda: train_state(sd, n_class=FSD.n_class, lr=FSD.lr,
                                        steps_per_epoch=FSD_STEPS_PER_EPOCH),
        "fsd50k train step")
    state, device_ms, wall_ms, peak, losses = timed_steps(step, state, batch, gen, cfg)
    clips_s = FSD.batch_size / wall_ms * 1e3
    print(f"fsd50k train step, {TIMED_STEPS} steps after {WARM_STEPS} warm-up: device "
          f"{np.mean(device_ms):.2f} ms/step (CUDA events; {min(device_ms):.2f}-"
          f"{max(device_ms):.2f}), wall {wall_ms:.2f} ms/step, {clips_s:.1f} clips/s; peak "
          f"memory {peak / 2**30:.2f} GiB; losses {losses[0]:.4f} .. {losses[-1]:.4f} "
          f"({card()})")
    return clips_s, float(np.mean(device_ms))


def fsd_trainer(paths: dict[str, str], root: str) -> int:
    """(d) ``psla-torch-train --preset fsd50k`` (``cli.run``) on (a)'s
    datafiles, one epoch from a fresh start: the fbank launches (set to 0
    just before, read just after) must be the train steps plus every eval
    batch; result.csv and the prediction CSVs finite. Returns the launches."""
    exp = os.path.join(root, "exp_fsd50k")
    argv = ["--preset", "fsd50k", "--data-train", paths["fsd50k_tr_full"], "--data-val",
            paths["fsd50k_val_full"], "--data-eval", paths["fsd50k_eval_full"],
            "--label-csv", assets.fsd50k_label_csv(), "--exp-dir", exp, "--impretrain",
            "False", "--warmup", "False", "--n-epochs", "1", "--wa_start", "1", "--wa_end",
            "1", "--eff_b", str(EFF_B), "--target_length", str(FSD.target_length), "-b",
            str(FSD.batch_size), "--device", DEVICE]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fbank_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    run = run_cli(argv)
    torch.cuda.synchronize()
    launches, wall = fbank_cuda.LAUNCHES, time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    spe, vb = run.steps_per_epoch, run.val_loader.batches_per_epoch()
    eb = run.eval_loader.batches_per_epoch()
    # the train steps, validation and the wa model's, then the protocol:
    # best and wa on val and eval, the epoch checkpoint on eval
    want = spe + vb + vb + 2 * (vb + eb) + eb
    secs = run.train_seconds[1]
    print(f"psla-torch-train --preset fsd50k (cli.run: B{EFF_B}, {run.config.att_head} heads, "
          f"{run.config.n_class} classes, T={run.config.target_length}, batch "
          f"{run.config.batch_size}, float32, mixup {run.config.mixup}, SpecAugment "
          f"{run.config.freqm}/{run.config.timem}, bal): 1 epoch of {spe} steps in {secs:.3f} s "
          f"of train loop ({spe * run.config.batch_size / secs:.1f} clips/s), {wall:.2f} s in "
          f"all with validation and the protocol; fbank launches {launches} (train steps "
          f"{spe} + eval batches {want - spe}); peak memory {peak / 2**30:.2f} GiB ({card()})")
    check(launches == want, f"{launches} fbank launches, want {want}")
    result = np.loadtxt(os.path.join(exp, "result.csv"), delimiter=",")
    check(result.shape == (10,) and bool(np.all(np.isfinite(result))), f"result.csv {result}")
    for name in ("predictions/target.csv", "predictions/predictions_1.csv",
                 "predictions/eval_target.csv", "predictions/predictions_eval_1.csv",
                 "best_single_result.csv", "wa_result.csv", "ensemble_result.csv"):
        values = np.loadtxt(os.path.join(exp, name), delimiter=",")
        check(values.size > 0 and bool(np.all(np.isfinite(values))), f"{name}: not finite")
    return launches


def tools_on_card(root: str) -> int:
    """(e) ``smoke.run`` and ``smoke.run_protocol`` on the card at the
    tool's own toy shape (B0, T=64); returns their fbank launches."""
    launches = 0
    for name, fn in (("smoke.run", lambda d: smoke.run(2, exp_root=d, device=DEVICE)),
                     ("smoke.run_protocol",
                      lambda d: smoke.run_protocol(1, exp_root=d, device=DEVICE))):
        d = tempfile.mkdtemp(dir=root)
        res, secs, n, _ = timed_tool(lambda: fn(d))
        launches += n
        extra = (f", {res['labels_added']} labels added, retrain loss "
                 f"{res['retrain_loss']:.6f} vs control {res['control_loss']:.6f}"
                 if "labels_added" in res else "")
        print(f"{name} on {smoke.device_name(DEVICE)}: {secs:.2f} s, fbank launches {n}, "
              f"summary {json.dumps(res['summary'])}{extra}")
        check(n > 0, f"{name}: the fbank kernel was not launched")
    return launches


def release_phase(eval_json: str, root: str) -> int:
    """(f) ``verify_release`` on a ``file://`` URL of a seeded B2 ``.pth`` of
    200 classes in the reference layout (``module.`` prefixes and an
    ``_fc``): every stage ok against the mAP ``tools/ensemble`` gives the
    same file, and the predict stage's probabilities within 1e-4 of
    ``predict_long`` through the plain fbank. Returns the fbank launches."""
    label_csv = assets.fsd50k_label_csv()
    sd = seeded_state_dict(RELEASE_SEED, n_class=FSD.n_class)
    ref = {f"module.{k}": v for k, v in sd.items()}
    ref["module.effnet._fc.weight"] = torch.zeros(FSD.n_class, 1408)
    ref["module.effnet._fc.bias"] = torch.zeros(FSD.n_class)
    pth = os.path.join(root, "fsd_release.pth")
    torch.save(ref, pth)
    pre = PreprocessConfig(target_length=FSD.target_length).eval_variant()
    loader = AudioLoader(load_datafile(eval_json, label_csv),
                         LoaderConfig(batch_size=16, drop_remainder=False,
                                      buffer_samples=pre.fbank.buffer_length(FSD.target_length)),
                         shuffle=False)
    expected = ensemble_tool.ensemble_eval([pth], loader, pre, n_class=FSD.n_class,
                                           eff_b=EFF_B, device=DEVICE)["models"][0]["mAP"]
    predicted = []
    run = predict_tool.run

    def recorded(argv):
        predicted.append(run(argv))
        return predicted[-1]

    predict_tool.run = recorded
    try:
        verdict, secs, launches, _ = timed_tool(lambda: verify_release.verify(
            "fsd_mdl_best_single", os.path.join(root, "zoo"), url=f"file://{pth}",
            eval_data=eval_json, label_csv=label_csv, expected_map=expected, eff_b=EFF_B,
            target_length=FSD.target_length, device=DEVICE))
    finally:
        predict_tool.run = run
    ((wav_path, probs),) = predicted[0].items()
    model = create_model("efficientnet", label_dim=FSD.n_class, eff_b=EFF_B, head_num=HEADS)
    model.load_state_dict(sd)
    want = predict_long(model.to(DEVICE), read_wav(wav_path)[0],
                        PreprocessConfig(target_length=FSD.target_length, fbank_method="fft64"),
                        device=DEVICE)
    err = float(np.abs(probs - want).max())
    print(f"verify_release fsd_mdl_best_single (file://, B{EFF_B}, {FSD.n_class} classes, "
          f"T={FSD.target_length}): {secs:.2f} s, stages "
          f"{ {k: v['ok'] for k, v in verdict['stages'].items()} }, eval mAP "
          f"{verdict['stages']['eval'].get('mAP')} against tools/ensemble's {expected:.6f} "
          f"(tolerance {verify_release.DEFAULT_TOLERANCE}); predict vs plain predict_long "
          f"max abs {err:.3e} (bar {PREDICT_ATOL}); fbank launches {launches}")
    check(verdict["ok"] and all(v["ok"] for v in verdict["stages"].values())
          and verdict["stages"]["eval"].get("within_tolerance"), f"verdict {verdict}")
    check(err <= PREDICT_ATOL, f"verify_release predict vs plain predict_long: {err}")
    return launches


def flagship_phase(root: str, step_clips_s: float):
    """(g) ``flagship.run`` at audioset_full width, killed at epoch 2's
    first print step and resumed; it must complete every epoch."""
    torch.cuda.empty_cache()
    out = os.path.join(root, "flagship")
    try:
        res = flagship.run(clips=FLAGSHIP_CLIPS, val_clips=FLAGSHIP_VAL_CLIPS,
                           epochs=FLAGSHIP_EPOCHS, out=out, device=DEVICE,
                           step_clips_per_sec=round(step_clips_s, 1))
    except BaseException:
        log = os.path.join(out, "run.log")
        if os.path.exists(log):
            with open(log) as f:
                print(f.read()[-6000:])
        raise
    print(f"flagship (B2, T={flagship.TARGET_LENGTH}, batch 128, {FLAGSHIP_CLIPS} train and "
          f"{FLAGSHIP_VAL_CLIPS} val clips, {FLAGSHIP_EPOCHS} epochs, killed at epoch "
          f"{res['killed_mid_epoch']}, resumed from epoch {res['resumed_from_epoch']}): "
          f"{json.dumps(res)} ({card()})")
    rates = res["epoch_clips_per_sec"]
    print(f"flagship loader-fed rate: epoch {FLAGSHIP_EPOCHS}'s train loop "
          f"{rates.get(FLAGSHIP_EPOCHS)} clips/s (each epoch: {rates}), the meters' median "
          f"{res['sustained_clips_per_sec']} clips/s (data share {res['data_time_share']}), "
          f"beside phase 6's float32 bare step {res['bare_step_clips_per_sec']} clips/s at batch "
          f"{STEP_BATCH}")
    check(res["resume_completed_epochs"] == FLAGSHIP_EPOCHS, f"flagship: {res}")
    check(res["resumed_from_epoch"] < FLAGSHIP_EPOCHS and res["wa_checkpoint"],
          f"flagship: {res}")
    check(res["device"]["device"] == DEVICE, f"flagship trained on {res['device']}")


def fsd_phase(step_clips_s: float) -> dict:
    """Phase 9: the FSD50K recipe and the tools on the card. Returns the
    fbank kernel's numbers at the fsd50k shape and its launches there."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="psla_fsd50k_")
    try:
        paths = fsd_prep(root)
        out = {f"{k}_fsd50k": v for k, v in fsd_fbank(paths["fsd50k_eval_full"]).items()}
        torch.cuda.empty_cache()
        out["clips_s_fsd50k_step"], _ = fsd_train_step()
        torch.cuda.empty_cache()
        out["launches_fsd50k_trainer_run"] = fsd_trainer(paths, root)
        torch.cuda.empty_cache()
        out["launches_smoke_tools"] = tools_on_card(root)
        out["launches_verify_release"] = release_phase(paths["fsd50k_eval_full"], root)
        flagship_phase(root, step_clips_s)
        print(f"phase 9: {time.perf_counter() - t_phase:.1f} s")
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------- phase 10

# The ResNet50 and MobileNetV2 backbones (psla_tpu/models/resnet.py and
# mobilenet.py, the reference's --model resnet|mbnet) at the audioset_full
# widths: 527 classes, T=1056, 128 mels, float32 with TF32 off unless
# stated. Serving and the tools on seeded members (seeded_state_dict), the
# train step as phase 6 takes it, the trainer on phase 7's corpus writer.
BACKBONES = ("resnet", "mbnet")
BACKBONE_SEEDS = (41, 42)


def ragged_dispatch(n: int, seed: int = 11):
    """A full micro-batch of tone clips with three ragged lengths (a third of
    the chunk, 5 s, nothing), zeros past each, and their means."""
    rng = np.random.default_rng(seed)
    wav = np.stack([tones(rng, n) for _ in range(BATCH)])
    lengths = np.full(BATCH, n, np.int32)
    lengths[1], lengths[2], lengths[3] = n // 3, 5 * SR, 0
    for i in (1, 2, 3):
        wav[i, lengths[i]:] = 0.0
    mean = (wav.sum(axis=1) / np.maximum(lengths, 1)).astype(np.float32)
    return wav, mean, lengths


def backbone_serving(name: str, sds: list[dict], names: dict) -> int:
    """(a) A 2-member ensemble through ``InferenceEngine.batch_probs`` at
    micro-batch 16: one fbank launch a dispatch (counted), the probabilities
    within 1e-4 of the same members on the plain fbank, then the clips/s of
    full dispatches in float32 and bfloat16. Returns the launches."""
    config = PreprocessConfig(target_length=TARGET)
    engine = InferenceEngine([member(sd, torch.float32, name) for sd in sds], config, names,
                             batch_size=BATCH, device=DEVICE)
    engine.close()  # dispatches are called directly: no batcher thread
    wav, mean, lengths = ragged_dispatch(engine.chunk_samples)
    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    got = engine.batch_probs(wav, mean, lengths)
    launches = fbank_cuda.LAUNCHES
    with torch.inference_mode():
        to = dict(device=DEVICE)
        want = ensemble_probs(engine.members, torch.from_numpy(wav).to(**to),
                              torch.from_numpy(mean).to(**to),
                              torch.from_numpy(lengths).to(**to),
                              dataclasses.replace(config, fbank_method="fft64")).cpu().numpy()
    check(fbank_cuda.LAUNCHES == launches, "the plain fbank launched the kernel")
    err = float(np.abs(got - want).max())
    print(f"{name} serving ({arch(engine.members[0])}, {N_CLASS} classes, T={TARGET}, "
          f"{len(sds)} members, batch {BATCH}, float32): fbank launches in one dispatch "
          f"{launches}; vs the plain fbank ('fft64') max abs {err:.3e} (bar {SERVE_ATOL}); "
          f"probabilities {got.min():.4f}..{got.max():.4f}, spread over clips "
          f"{np.ptp(got, axis=0).max():.3e}")
    check(launches == 1, f"{name}: {launches} fbank launches in one dispatch")
    check(bool(np.all(np.isfinite(got)) and np.all((got > 0) & (got < 1))),
          f"{name}: served probabilities not in (0, 1)")
    check(err <= SERVE_ATOL, f"{name}: served probabilities off the plain fbank by {err}")
    rate32, ms32, probs32 = dispatch_rate(engine, np.random.default_rng(11))
    del engine
    torch.cuda.empty_cache()
    bf16 = InferenceEngine([member(sd, torch.bfloat16, name) for sd in sds], config, names,
                           batch_size=BATCH, device=DEVICE)
    bf16.close()
    rate16, ms16, probs16 = dispatch_rate(bf16, np.random.default_rng(11))
    check(bool(np.all(np.isfinite(probs16))), f"{name}: bfloat16 probabilities not finite")
    print(f"{name} full {BATCH}-clip dispatch, {len(sds)} members: float32 {ms32:.2f} ms, "
          f"{rate32:.1f} clips/s; bfloat16 {ms16:.2f} ms, {rate16:.1f} clips/s, max abs vs "
          f"float32 {float(np.abs(probs16 - probs32).max()):.3e} ({card()})")
    return launches


def backbone_train_step(name: str, b2: tuple[float, float], profile: bool) -> int:
    """(b) The audioset_full train step (mixup 0.5, SpecAugment 48/192, Adam
    past warmup; no drop-connect in these backbones) at batch STEP_BATCH:
    one step through the kernel held to the plain fbank's at phase 6's
    bars, then 2 warm-up and 10 timed steps beside phase 6's B2 step
    (``b2``: its device ms and clips/s). Returns the fbank launches in the
    held step."""
    cfg = train_config()
    sd = seeded_state_dict(BACKBONE_SEEDS[0], model=name)
    batch = train_batch(cfg)
    state, _, _, step, gen, _, _ = step_held_to_plain(
        cfg, batch, lambda: train_state(sd, model_name=name), f"{name} train step")
    state, device_ms, wall_ms, peak, losses = timed_steps(step, state, batch, gen, cfg)
    print(f"{name} train step ({arch(state.model)}, batch {STEP_BATCH}), {TIMED_STEPS} "
          f"steps after {WARM_STEPS} warm-up: device {np.mean(device_ms):.2f} ms/step "
          f"(CUDA events; {min(device_ms):.2f}-{max(device_ms):.2f}), wall {wall_ms:.2f} ms/step, "
          f"{STEP_BATCH / wall_ms * 1e3:.1f} clips/s; peak memory {peak / 2**30:.2f} GiB; losses "
          f"{losses[0]:.4f} .. {losses[-1]:.4f}; phase 6's B2 step in this call: device "
          f"{b2[0]:.2f} ms/step, {b2[1]:.1f} clips/s at batch {STEP_BATCH} ({card()})")
    if profile:
        profile_train_step(state, step, batch, gen, cfg)
    return 1  # checked in step_held_to_plain


def backbone_tools(name: str, sds: list[dict], root: str, eval_json: str) -> int:
    """(c) psla-torch-predict on a 60 s clip within 1e-4 of ``predict_long``
    on the plain fbank (ResNet through the pooling statistics, MBNet
    through the length-weighted fallback); ``tools/ensemble.main`` on 2
    saved members (one with DataParallel prefixes), stacked and
    ``--sequential``, within 1e-5 of each other, launches counted as in
    phase 8; ``convert_ckpt`` round-trips a member. Returns the launches."""
    label_csv = assets.label_csv_for("audioset")
    paths = []
    for i, sd in enumerate(sds):
        path = os.path.join(root, f"{name}_{i}.pth")
        torch.save({f"module.{k}": v for k, v in sd.items()} if i == 0 else sd, path)
        paths.append(path)
    width = ["--model", name, "--target_length", str(TARGET), "--device", DEVICE]
    launches = 0

    clip_path = os.path.join(root, f"{name}_long60s.wav")
    with open(clip_path, "wb") as f:
        f.write(wav_bytes(tones(np.random.default_rng(13), PREDICT_SECONDS * SR), SR))
    got, secs, n, _ = timed_tool(lambda: predict_tool.run(
        [clip_path, "--ckpt", paths[1], "--label-csv", label_csv] + width))
    launches += n
    wav = decode_wav(open(clip_path, "rb").read())[0]
    want = predict_long(member(sds[1], torch.float32, name).to(DEVICE), wav,
                        PreprocessConfig(target_length=TARGET, fbank_method="fft64"),
                        device=DEVICE)
    err = float(np.abs(got[clip_path] - want).max())
    chunks = -(-wav.size // PreprocessConfig(target_length=TARGET).fbank.buffer_length(TARGET))
    print(f"{name} psla-torch-predict, {PREDICT_SECONDS} s clip ({chunks} chunks, "
          f"{'pooling statistics' if name == 'resnet' else 'length-weighted chunks'}): "
          f"{secs:.3f} s; max abs vs the plain fbank's predict_long {err:.3e} (bar "
          f"{PREDICT_ATOL}); fbank launches {n}")
    check(err <= PREDICT_ATOL, f"{name} predict vs plain predict_long: {err}")
    check(n == -(-chunks // 8), f"{name} predict: {n} fbank launches")

    argv = paths + ["--data-eval", eval_json, "--label-csv", label_csv, "--preset",
                    "audioset_full", "--batch-size", str(EVAL_BATCH)] + width
    n_batches = -(-EVAL_CLIPS // EVAL_BATCH)
    preds = {}
    for mode, extra in (("stacked", []), ("sequential", ["--sequential"])):
        out = os.path.join(root, f"{name}_{mode}")
        rc, secs, n, _ = timed_tool(lambda: ensemble_tool.main(argv + ["--out-dir", out] + extra))
        check(rc == 0, f"{name} ensemble {mode}: exit {rc}")
        preds[mode] = np.stack([np.loadtxt(os.path.join(out, f"predictions_{i}.csv"),
                                           delimiter=",") for i in range(len(paths))])
        want_n = n_batches * (1 if mode == "stacked" else len(paths))
        print(f"{name} ensemble {mode} (tools/ensemble.main, {len(paths)} members, "
              f"{EVAL_CLIPS} clips, batch {EVAL_BATCH}): {secs:.3f} s, fbank launches {n} "
              f"(want {want_n})")
        check(n == want_n, f"{name} ensemble {mode}: {n} fbank launches, want {want_n}")
        check(preds[mode].shape == (len(paths), EVAL_CLIPS, N_CLASS)
              and bool(np.all(np.isfinite(preds[mode]))), f"{name} ensemble {mode} predictions")
        launches += n
    err = float(np.abs(preds["stacked"] - preds["sequential"]).max())
    print(f"{name} ensemble: stacked vs sequential max abs {err:.3e} (bar {ENSEMBLE_ATOL})")
    check(err <= ENSEMBLE_ATOL, f"{name} stacked vs sequential: {err}")

    out = os.path.join(root, f"{name}_converted.pth")
    check(convert_tool.main(["--pth", paths[0], "--model", name, "--n-class", str(N_CLASS),
                             "--out", out]) == 0, f"{name} convert_ckpt")
    back = torch.load(out, weights_only=True)
    check(back.keys() == sds[0].keys() and all(torch.equal(back[k], sds[0][k]) for k in back),
          f"{name} convert_ckpt did not round-trip the member")
    print(f"{name} convert_ckpt: the member round-trips exactly ({len(back)} entries)")
    return launches


def torchvision_resnet50(sd: dict, seed: int = 43) -> dict:
    """A ResNetAttention state_dict laid out as torchvision's ImageNet
    resnet50 file: no ``model.`` prefix, a seeded 3-channel ``conv1``, an
    ``fc`` classifier, no attention head."""
    rng = np.random.default_rng(seed)
    out = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    out["conv1.weight"] = torch.from_numpy(
        rng.normal(0.0, 0.1, (64, 3, 7, 7)).astype(np.float32))
    out["fc.weight"] = torch.zeros(1000, 2048)
    out["fc.bias"] = torch.zeros(1000)
    return out


def backbone_trainer(root: str, train_json: str, val_json: str) -> int:
    """(d) ``cli.run --model resnet`` for 1 epoch from ``impretrain`` with a
    seeded torchvision-layout ``resnet50-seeded.pth`` named by
    PSLA_TPU_IMAGENET_CKPT: the run's initial stem is the fresh init's and
    every other backbone entry the file's; the fbank launches are the train
    steps plus the eval batches; the CSVs finite; the wa checkpoint serves.
    Returns the launches."""
    imagenet = torchvision_resnet50(seeded_state_dict(BACKBONE_SEEDS[1], model="resnet"))
    path = os.path.join(root, "resnet50-seeded.pth")
    torch.save(imagenet, path)
    exp = os.path.join(root, "exp_resnet")
    argv = ["--preset", "audioset_full", "--model", "resnet", "--data-train", train_json,
            "--data-val", val_json, "--data-eval", val_json, "--label-csv",
            assets.label_csv_for("audioset"), "--exp-dir", exp, "--warmup", "False",
            "--n-epochs", "1", "--wa_start", "1", "--wa_end", "1", "--target_length",
            str(TARGET), "-b", str(STEP_BATCH), "--device", DEVICE]
    before = os.environ.get(CKPT_ENV)
    os.environ[CKPT_ENV] = path
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fbank_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        run = run_cli(argv)
        torch.cuda.synchronize()
        launches, wall = fbank_cuda.LAUNCHES, time.perf_counter() - t0
    finally:
        if before is None:
            os.environ.pop(CKPT_ENV)
        else:
            os.environ[CKPT_ENV] = before
    check(run.config.impretrain, "impretrain is not the preset's default")
    fresh = run._new_model().state_dict()
    stem_fresh = torch.equal(run.initial["model.conv1.weight"], fresh["model.conv1.weight"])
    from_file = all(torch.equal(run.initial[f"model.{k}"], v) for k, v in imagenet.items()
                    if f"model.{k}" in run.initial and k != "conv1.weight")
    head_fresh = all(torch.equal(run.initial[k], fresh[k]) for k in fresh
                     if k.startswith("attention."))
    n_file = sum(f"model.{k}" in run.initial for k in imagenet) - 1
    spe, vb = run.steps_per_epoch, run.val_loader.batches_per_epoch()
    eb = run.eval_loader.batches_per_epoch()
    want = spe + vb + vb + 2 * (vb + eb) + eb  # as fsd_trainer counts them
    secs = run.train_seconds[1]
    print(f"psla-torch-train --model resnet (cli.run, audioset_full: ResNet50, {N_CLASS} "
          f"classes, T={TARGET}, batch {STEP_BATCH}, float32, mixup, SpecAugment, bal) from "
          f"{CKPT_ENV}: initial stem the fresh init's {stem_fresh}, {n_file} backbone entries "
          f"the file's {from_file}, attention head fresh {head_fresh}; 1 epoch of {spe} steps "
          f"in {secs:.3f} s of train loop ({spe * STEP_BATCH / secs:.1f} clips/s), {wall:.2f} s "
          f"in all; fbank launches {launches} (train steps {spe} + eval batches "
          f"{want - spe}); peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"({card()})")
    check(stem_fresh and from_file and head_fresh, "the ImageNet init is not stem-fresh, "
                                                   "file-backbone, head-fresh")
    check(launches == want, f"resnet trainer: {launches} fbank launches, want {want}")
    for name in ("result.csv", "predictions/target.csv", "predictions/predictions_1.csv",
                 "predictions/predictions_eval_1.csv", "wa_result.csv",
                 "best_single_result.csv", "ensemble_result.csv"):
        values = np.loadtxt(os.path.join(exp, name), delimiter=",")
        check(values.size > 0 and bool(np.all(np.isfinite(values))), f"{name}: not finite")
    model = create_model("resnet", label_dim=N_CLASS)
    model.load_state_dict(load_variables(os.path.join(exp, "models", "wa")))
    engine = InferenceEngine([model], PreprocessConfig(target_length=TARGET),
                             make_name_dict(assets.label_csv_for("audioset")), batch_size=4,
                             device=DEVICE)
    try:
        probs = engine.predict(decode_wav(open(os.path.join(root, "val_0000.wav"), "rb")
                                          .read())[0], SR)
    finally:
        engine.close()
    check(probs.shape == (N_CLASS,) and bool(np.all(np.isfinite(probs))),
          "the resnet wa checkpoint served non-finite probabilities")
    print(f"resnet wa checkpoint served: probabilities {probs.min():.4f}..{probs.max():.4f}")
    return launches


def backbones_phase(b2: tuple[float, float], profile: bool) -> dict:
    """Phase 10: ResNetAttention and MBNet on the card. Returns the fbank
    kernel's launches on each of their paths."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="psla_backbones_")
    out = {}
    try:
        t0 = time.perf_counter()
        train_json, val_json, _ = write_corpus(root, val_clips=EVAL_CLIPS)
        print(f"phase 10 corpus: {TRAIN_CLIPS} train and {EVAL_CLIPS} val clips written in "
              f"{time.perf_counter() - t0:.2f} s")
        names = make_name_dict(assets.label_csv_for("audioset"))
        for name in BACKBONES:
            sds = [seeded_state_dict(s, model=name) for s in BACKBONE_SEEDS]
            out[f"launches_{name}_serving"] = backbone_serving(name, sds, names)
            torch.cuda.empty_cache()
            out[f"launches_{name}_train_step"] = backbone_train_step(name, b2, profile)
            torch.cuda.empty_cache()
            out[f"launches_{name}_tools"] = backbone_tools(name, sds, root, val_json)
            torch.cuda.empty_cache()
        out["launches_resnet_trainer_run"] = backbone_trainer(root, train_json, val_json)
        print(f"phase 10: {time.perf_counter() - t_phase:.1f} s; fbank launches {out}")
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------- phase 11

# Multi-seed ensemble training (psla-torch-train --ensemble-seeds E; the
# reference README's 10-model ensemble) at the audioset_full widths: E
# members of B2 (4 heads, 527 classes, T=1056, batch 100, float32 with TF32
# off) step in lockstep on one shared batch, each with its own draws.
ENSEMBLE_SEEDS = tuple(range(51, 61))  # seeded weights of up to 10 members
HELD_MEMBERS, PAPER_MEMBERS = 2, 10


class RecordingEnsembleTrainer(EnsembleTrainer):
    """The CLI's ensemble trainer, kept so its loaders and step count can be
    read after the run."""

    runs: list = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        RecordingEnsembleTrainer.runs.append(self)


def run_ensemble_cli(argv: list[str]) -> tuple[RecordingEnsembleTrainer, dict]:
    RecordingEnsembleTrainer.runs.clear()
    cli.EnsembleTrainer = RecordingEnsembleTrainer
    try:
        summary = cli.run(argv)
    finally:
        cli.EnsembleTrainer = EnsembleTrainer
    (trainer,) = RecordingEnsembleTrainer.runs
    return trainer, summary


def ensemble_state(seeds) -> EnsembleState:
    return EnsembleState([train_state(seeded_state_dict(s)) for s in seeds])


def ensemble_step(b2: tuple[float, float]) -> int:
    """(a) The ensemble train step at E=2 on seeded weights: one step
    (launches set to 0 just before, read just after: E) held member by
    member to the single-model step fed that member's draws (loss and
    running statistics 1e-5, parameters 2 x lr); then warm-up and timed
    steps (device ms, clips/s of the shared stream, peak memory), and one
    timed step at E=10. Returns the launches of the held step."""
    cfg = train_config()
    batch = train_batch(cfg, batch=STEP_BATCH)
    e = HELD_MEMBERS
    state = ensemble_state(ENSEMBLE_SEEDS[:e])
    singles = [train_state(seeded_state_dict(s)) for s in ENSEMBLE_SEEDS[:e]]
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "TF32 is on for a float32 train step")
    lr = state.members[0].schedule(state.step)
    n_params = sum(p.numel() for p in state.members[0].model.parameters())
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    draws = [draw_train(gen, state.members[0].model, STEP_BATCH, cfg) for _ in range(e)]
    step = make_ensemble_train_step(cfg)
    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    state, metrics = step(state, batch, draws)
    torch.cuda.synchronize()
    launches = fbank_cuda.LAUNCHES
    seed_loss = [float(x) for x in metrics["seed_loss"]]
    mean_err = abs(float(metrics["loss"]) - float(np.mean(seed_loss)))
    print(f"ensemble train step, E={e} (B{EFF_B}, {HEADS} heads, {N_CLASS} classes, "
          f"T={TARGET}, batch {STEP_BATCH} shared, float32, TF32 off; {n_params} parameters "
          f"a member): fbank launches {launches}; seed losses {seed_loss}, mean "
          f"{float(metrics['loss']):.6f} (off the mean of the seeds by {mean_err:.1e})")
    check(launches == e, f"{launches} fbank launches in one E={e} ensemble step")
    check(bool(np.all(np.isfinite(seed_loss))) and mean_err <= 1e-6,
          f"ensemble losses {seed_loss}, mean {float(metrics['loss'])}")
    check(abs(seed_loss[0] - seed_loss[1]) > 1e-6, "the members' losses are equal")
    single = build_train_step(cfg)
    for i, held in enumerate(state.members):
        singles[i], m = single(singles[i], batch, draws[i])
        after, want = held.model.state_dict(), singles[i].model.state_dict()
        stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
        params = [k for k, _ in held.model.named_parameters()]
        loss_err = abs(seed_loss[i] - float(m["loss"]))
        stats_err, param_err = max_diff(after, want, stats), max_diff(after, want, params)
        print(f"member {i} vs the single-model step on its draws: loss {loss_err:.3e} (bar "
              f"{STEP_LOSS_ATOL}), running statistics {stats_err:.3e} (bar {STATS_ATOL}), "
              f"parameters {param_err:.3e} (bar {2 * lr})")
        check(loss_err <= STEP_LOSS_ATOL, f"member {i}: loss off by {loss_err}")
        check(stats_err <= STATS_ATOL, f"member {i}: running statistics off by {stats_err}")
        check(param_err <= 2 * lr, f"member {i}: parameters off by {param_err}")
    del singles
    torch.cuda.empty_cache()

    state, device_ms, wall_ms, peak, losses = timed_steps(step, state, batch, gen, cfg,
                                                          members=e)
    ms = float(np.mean(device_ms))
    print(f"ensemble train step E={e}, {TIMED_STEPS} steps after {WARM_STEPS} warm-up: "
          f"device {ms:.2f} ms/step (CUDA events; {min(device_ms):.2f}-{max(device_ms):.2f}), "
          f"wall {wall_ms:.2f} ms/step, {STEP_BATCH / wall_ms * 1e3:.1f} clips/s of the shared "
          f"stream ({e * STEP_BATCH / wall_ms * 1e3:.1f} member-clips/s); peak memory "
          f"{peak / 2**30:.2f} GiB; {ms / (e * b2[0]):.3f} x E x phase 6's single step "
          f"({b2[0]:.2f} ms, {b2[1]:.1f} clips/s in this call) ({card()})")
    schedule = state.members[0].schedule
    del state
    torch.cuda.empty_cache()

    e = PAPER_MEMBERS
    t0 = time.perf_counter()
    state = init_ensemble_state(lambda s: member(seeded_state_dict(s), torch.float32),
                                ENSEMBLE_SEEDS[:e], schedule, step=START_STEP, device=DEVICE)
    setup = time.perf_counter() - t0
    state, device_ms, wall_ms, peak, losses = timed_steps(step, state, batch, gen, cfg,
                                                          members=e, warm=1, timed=1)
    print(f"ensemble train step E={e} (members built in {setup:.1f} s), 1 step after 1 "
          f"warm-up: device {device_ms[0]:.2f} ms, wall {wall_ms:.2f} ms, "
          f"{STEP_BATCH / wall_ms * 1e3:.1f} clips/s of the shared stream; peak memory "
          f"{peak / 2**30:.2f} GiB; {device_ms[0] / (e * b2[0]):.3f} x E x phase 6's single "
          f"step; losses {losses} ({card()})")
    return launches


def ensemble_eval_step() -> int:
    """(b) The ensemble eval step on a batch of 100 clips: each member's
    probabilities within 1e-5 of its own single-model eval step, one fbank
    launch (set to 0 just before, read just after); both timed. Returns
    the launches."""
    cfg = train_config()
    batch = train_batch(cfg, seed=8, batch=STEP_BATCH)
    state = ensemble_state(ENSEMBLE_SEEDS[:HELD_MEMBERS])
    step, single = make_ensemble_eval_step(cfg), build_eval_step(cfg)
    torch.cuda.synchronize()
    fbank_cuda.LAUNCHES = 0
    probs, losses = step(state, batch)
    torch.cuda.synchronize()
    launches = fbank_cuda.LAUNCHES
    check(launches == 1, f"{launches} fbank launches in one ensemble eval step")
    check(tuple(probs.shape) == (HELD_MEMBERS, STEP_BATCH, N_CLASS)
          and bool(torch.isfinite(probs).all()), f"ensemble eval: {tuple(probs.shape)}")
    errs = []
    for i, m in enumerate(state.members):
        want, want_loss = single(m, batch)
        errs.append(max(float((probs[i] - want).abs().max()),
                        float((losses[i] - want_loss).abs().max())))
    ens_ms = cuda_ms(lambda: step(state, batch), reps=5, warmup=1)
    seq_ms = cuda_ms(lambda: [single(m, batch) for m in state.members], reps=5, warmup=1)
    print(f"ensemble eval step E={HELD_MEMBERS}, batch {STEP_BATCH}: fbank launches "
          f"{launches}; each member vs its single-model eval step: max abs err {errs} (bar "
          f"{ENSEMBLE_ATOL}); {ens_ms:.2f} ms against {seq_ms:.2f} ms for the members' single "
          f"steps in turn (CUDA events) ({card()})")
    check(max(errs) <= ENSEMBLE_ATOL, f"ensemble eval off the single steps by {max(errs)}")
    return launches


def ensemble_trainer(root: str, train_json: str, val_json: str) -> tuple[int, int]:
    """(c) ``cli.run --preset audioset_full --ensemble-seeds 2`` for 2 epochs
    with weight averaging over 1-2 and the protocol on the val list as the
    eval set, then ``--resume --n-epochs 3``: the fbank launches of each run
    (set to 0 just before, read just after) are E x the train steps plus the
    eval batches; the per-seed files, seed_result.csv's rows, the stacked
    step; ``tools/ensemble.ensemble_eval`` reads best_seed0 and best_seed1
    on the card. Returns the launches of the two runs."""
    e = HELD_MEMBERS
    exp = os.path.join(root, "exp_ensemble")
    base = ["--preset", "audioset_full", "--data-train", train_json, "--data-val", val_json,
            "--data-eval", val_json, "--label-csv", assets.label_csv_for("audioset"),
            "--exp-dir", exp, "--impretrain", "False", "--warmup", "False", "--wa_start",
            "1", "--wa_end", "2", "--eff_b", str(EFF_B), "--target_length", str(TARGET),
            "-b", str(STEP_BATCH), "--ensemble-seeds", str(e), "--device", DEVICE]
    out = []
    for epochs, extra in ((2, []), (3, ["--resume"])):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fbank_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        run, summary = run_ensemble_cli(base + ["--n-epochs", str(epochs)] + extra)
        torch.cuda.synchronize()
        launches, wall = fbank_cuda.LAUNCHES, time.perf_counter() - t0
        spe, vb = run.steps_per_epoch, run.val_loader.batches_per_epoch()
        eb = run.eval_loader.batches_per_epoch()
        trained = epochs - (2 if extra else 0)
        # each epoch's validation, wa, then best and wa on val and eval and
        # every epoch checkpoint on eval
        evals = trained * vb + vb + 2 * (vb + eb) + epochs * eb
        want = e * trained * spe + evals
        secs = run.train_seconds[epochs]
        print(f"psla-torch-train --ensemble-seeds {e} {' '.join(extra)} (cli.run, "
              f"audioset_full: B{EFF_B}, {HEADS} heads, {N_CLASS} classes, T={TARGET}, batch "
              f"{STEP_BATCH}): {trained} epoch(s) of {spe} steps, {wall:.2f} s in all, epoch "
              f"{epochs}'s train loop {secs:.3f} s ({spe * STEP_BATCH / secs:.1f} clips/s of "
              f"the shared stream); fbank launches {launches} (E x train steps "
              f"{e * trained * spe} + eval batches {evals}); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; summary "
              f"{json.dumps(summary)} ({card()})")
        check(launches == want, f"ensemble trainer: {launches} fbank launches, want {want}")
        out.append(launches)
        ckpt = torch.load(os.path.join(exp, "models", f"epoch_{epochs}", "checkpoint.pth"),
                          map_location="cpu", weights_only=True)
        check(ckpt["seeds"] == e and ckpt["step"] == epochs * spe
              and all(v.shape[0] == e for v in ckpt["model"].values()),
              f"stacked epoch_{epochs}: seeds {ckpt['seeds']}, step {ckpt['step']}")
        rows = {}
        with open(os.path.join(exp, "seed_result.csv")) as f:
            for line in f:
                fields = line.strip().split(",")
                rows[fields[0]] = [float(x) for x in fields[1:]]
        tags = [str(i) for i in range(1, epochs + 1)] + [
            "wa", "best_single_valid_set", "best_single_eval_set", "wa_valid_set",
            "wa_eval_set"] + [f"eval_{i}" for i in range(1, epochs + 1)]
        check(sorted(rows) == sorted(tags) and list(rows)[:epochs] == tags[:epochs]
              and all(len(v) == e + 1 and np.all(np.isfinite(v)) for v in rows.values()),
              f"seed_result.csv rows {rows}")
        pred = os.path.join(exp, "predictions")
        means = np.loadtxt(os.path.join(pred, f"predictions_{epochs}.csv"), delimiter=",")
        seeds = [np.loadtxt(os.path.join(pred, f"predictions_{epochs}_seed{i}.csv"),
                            delimiter=",") for i in range(e)]
        mean_err = float(np.abs(means - np.mean(seeds, axis=0)).max())
        check(mean_err <= 1e-6 and not os.path.exists(
            os.path.join(pred, f"predictions_{epochs - 1}_seed0.csv")),
            f"predictions_{epochs}.csv is {mean_err} off the seed mean, or an older "
            "epoch's member matrix is left")
        for tag in ("best", "wa"):
            for i in range(e):
                check(os.path.exists(os.path.join(exp, "models", f"{tag}_seed{i}",
                                                  "checkpoint.pth")), f"{tag}_seed{i} missing")
        print(f"seed_result.csv epoch {epochs}: member mAPs {rows[str(epochs)][:e]}, "
              f"ensemble {rows[str(epochs)][e]:.4f}; predictions_{epochs}.csv {mean_err:.1e} "
              f"off the mean of the members'")

    # the per-seed extracts through the ensemble tool, on the card
    cfg = cli.config_from_args(cli.build_parser().parse_args(base + ["--n-epochs", "3"]))
    loader = cli.make_loaders(cfg)[1]
    tool_out = os.path.join(root, "ensemble_tool")
    fbank_cuda.LAUNCHES = 0
    res = ensemble_tool.ensemble_eval(
        [os.path.join(exp, "models", f"best_seed{i}") for i in range(e)], loader,
        cfg.preprocess_config(), n_class=N_CLASS, eff_b=EFF_B, out_dir=tool_out,
        device=DEVICE)
    tool_launches = fbank_cuda.LAUNCHES
    errs = [float(np.abs(
        np.loadtxt(os.path.join(tool_out, f"predictions_{i}.csv"), delimiter=",")
        - np.loadtxt(os.path.join(exp, "predictions",
                                  f"predictions_best_single_valid_set_seed{i}.csv"),
                     delimiter=",")).max()) for i in range(e)]
    print(f"tools/ensemble.ensemble_eval on best_seed0..{e - 1}: mAP {res['ensemble']['mAP']:.4f}, "
          f"fbank launches {tool_launches} ({loader.batches_per_epoch()} batches); members "
          f"vs the protocol's best_single_valid_set_seed matrices: {errs} (bar {ENSEMBLE_ATOL})")
    check(tool_launches == loader.batches_per_epoch(), f"ensemble tool: {tool_launches} "
                                                       "fbank launches")
    check(max(errs) <= ENSEMBLE_ATOL and np.isfinite(res["ensemble"]["mAP"]),
          f"the ensemble tool's member predictions off by {errs}")
    return out[0], out[1]


def ensemble_phase(b2: tuple[float, float]) -> dict:
    """Phase 11: multi-seed ensemble training on the card. Returns the fbank
    kernel's launches on each of its paths."""
    t_phase = time.perf_counter()
    out = {"launches_ensemble_train_step": ensemble_step(b2)}
    torch.cuda.empty_cache()
    out["launches_ensemble_eval_step"] = ensemble_eval_step()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="psla_ensemble_")
    try:
        train_json, val_json, _ = write_corpus(root)
        (out["launches_ensemble_trainer_run"],
         out["launches_ensemble_trainer_resume"]) = ensemble_trainer(root, train_json, val_json)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s; fbank launches {out}")
    return out


# ---------------------------------------------------------------- phase 12

# Data parallelism on torch.distributed. NCCL takes one rank a card, and the
# script needs one card: (a) runs world 1 under NCCL in this process; (b)
# and (c) run world 2 under gloo with both ranks on cuda:0, two processes
# sharing one card over loopback, so their times measure that, not scaling
# over cards. ``--data-parallel N`` runs this phase alone with N ranks
# under NCCL, one a card.
DP_WORLD = 2
# tests/test_parallel.py:90-100: the loss, the parameters (max in units of
# lr, mean, 99th percentile) of a data-parallel step against one device's
DP_LOSS_ATOL, DP_PARAM_LRS, DP_PARAM_MEAN, DP_PARAM_P99 = 3e-4, 3, 1e-5, 1e-4
DP_EVAL_ATOL = 1e-5  # tests/test_parallel.py:115, the sharded eval step
# (b)'s timed steps: two processes sharing one card under gloo time the
# sharing, not scaling, so a few steps do; on N cards the full count
SHARED_WARM, SHARED_TIMED = 1, 3


def dp_timing(backend: str) -> tuple[int, int]:
    """(warm-up, timed) steps of (b) under ``backend``."""
    return (SHARED_WARM, SHARED_TIMED) if backend == "gloo" else (WARM_STEPS, TIMED_STEPS)


def free_port() -> int:
    """A free TCP port on the loopback address, for NCCL's rendezvous."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def join_group(rank: int, store: str, world: int, backend: str):
    """A spawned rank of phase 12: under gloo every rank on cuda:0, under
    NCCL rank r on cuda:r."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    check(maybe_initialize(rank=rank, world_size=world, init_method=store, backend=backend,
                           local_rank=0 if backend == "gloo" else rank, device=DEVICE),
          f"the {backend} group did not start")


def where(world: int, backend: str) -> str:
    return ("one card (cuda:0 for every rank)" if backend == "gloo"
            else f"{world} cards (cuda:0-{world - 1})")


def spawn_ranks(fn, root: str, world: int, backend: str, *args) -> list[dict]:
    """``fn(rank, store, root, world, backend, *args)`` in ``world`` spawned
    processes meeting at a file store under ``root``; each saves its results
    to ``{root}/rank{rank}.pt``, which this returns in rank order. A failing
    rank fails the phase."""
    store = "file://" + os.path.join(root, "store")
    torch.multiprocessing.spawn(fn, args=(store, root, world, backend, *args), nprocs=world,
                                join=True)
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def param_diffs(got: dict, want: dict, keys) -> np.ndarray:
    return torch.cat([(got[k].float().cpu() - want[k].float().cpu()).abs().flatten()
                      for k in keys]).numpy()


def dp_world_one(b2: tuple[float, float] | None) -> tuple[int, dict, float, tuple]:
    """(a) World 1 under NCCL (RANK=0, WORLD_SIZE=1 and ``maybe_initialize``):
    the data-parallel step (``build_train_step`` on the mesh) held to phase
    6's one-process step on the same state, batch and draws (loss and
    running statistics 1e-5, parameters 2 x lr), one fbank launch (set to 0
    just before, read just after), then timed beside phase 6's step ``b2``
    (device ms, clips/s) if given. Returns the launches, the held step's
    state_dict on the host, its loss, and its (device ms, clips/s)."""
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    os.environ.update(env)
    try:
        check(maybe_initialize(), "the NCCL group did not start")
        mesh = make_mesh(device=DEVICE)
        check(dist.get_backend() == "nccl" and (mesh.world, mesh.rank) == (1, 0),
              f"{dist.get_backend()} group of {mesh.world}")
        cfg, sd = train_config(), seeded_state_dict(SEEDS[0])
        batch = train_batch(cfg)
        ref_state = train_state(sd)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        draws = draw_train(gen, ref_state.model, STEP_BATCH, cfg)
        lr = ref_state.schedule(ref_state.step)
        ref_state, ref_metrics = build_train_step(cfg)(ref_state, batch, draws)
        want = {k: v.clone() for k, v in ref_state.model.state_dict().items()}
        del ref_state
        state = replicate_state(train_state(sd), mesh)
        step = build_train_step(cfg, "BCE", mesh)
        torch.cuda.synchronize()
        fbank_cuda.LAUNCHES = 0
        state, metrics = step(state, batch, draws)
        torch.cuda.synchronize()
        launches = fbank_cuda.LAUNCHES
        after = state.model.state_dict()
        stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
        params = [k for k, _ in state.model.named_parameters()]
        loss = float(metrics["loss"])
        loss_err = abs(loss - float(ref_metrics["loss"]))
        stats_err, param_err = max_diff(after, want, stats), max_diff(after, want, params)
        bit_equal = all(torch.equal(after[k], want[k]) for k in after)
        print(f"(a) world 1 under NCCL, audioset_full step at batch {STEP_BATCH} through the "
              f"mesh: fbank launches {launches}; vs phase 6's one-process step: loss "
              f"{loss_err:.3e} (bar {STEP_LOSS_ATOL}), running statistics {stats_err:.3e} "
              f"(bar {STATS_ATOL}), parameters {param_err:.3e} (bar {2 * lr}); bit-equal: "
              f"{bit_equal}")
        check(launches == 1, f"{launches} fbank launches in a world-1 step")
        check(loss_err <= STEP_LOSS_ATOL and stats_err <= STATS_ATOL and param_err <= 2 * lr,
              f"world-1 step off phase 6's: {loss_err}, {stats_err}, {param_err}")
        host = {k: v.detach().cpu().clone() for k, v in after.items()}
        state, device_ms, wall_ms, peak, _ = timed_steps(step, state, batch, gen, cfg)
        beside = ("" if b2 is None else f"; phase 6's step in this call {b2[0]:.2f} ms "
                  f"device, {b2[1]:.1f} clips/s")
        print(f"(a) world 1 under NCCL, {TIMED_STEPS} steps after {WARM_STEPS}: device "
              f"{np.mean(device_ms):.2f} ms/step (CUDA events; {min(device_ms):.2f}-"
              f"{max(device_ms):.2f}), wall {wall_ms:.2f} ms/step, "
              f"{STEP_BATCH / wall_ms * 1e3:.1f} clips/s, peak {peak / 2**30:.2f} GiB{beside} "
              f"({card()})")
        return launches, host, loss, (float(np.mean(device_ms)), STEP_BATCH / wall_ms * 1e3)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)


def dp_step_rank(rank: int, store: str, root: str, world: int, backend: str):
    """(b) One rank: its share of phase 6's batch through the data-parallel
    step from the same state with the global batch's draws (the first
    step's fbank launches counted), then the warm-up and timed steps of
    ``dp_timing``, then the eval step on its rows of a batch of 100,
    gathered."""
    join_group(rank, store, world, backend)
    warm, timed = dp_timing(backend)
    try:
        mesh = make_mesh(device=DEVICE)
        cfg, sd = train_config(), seeded_state_dict(SEEDS[0])
        batch = shard_batch(train_batch(cfg), mesh)
        state = replicate_state(train_state(sd), mesh)
        step = build_train_step(cfg, "BCE", mesh)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        draws = draw_train(gen, state.model, STEP_BATCH, cfg)
        torch.cuda.synchronize()
        fbank_cuda.LAUNCHES = bn_train.LAUNCHES_FW = bn_train.LAUNCHES_BW = 0
        state, metrics = step(state, batch, draws)
        torch.cuda.synchronize()
        out = {"launches": fbank_cuda.LAUNCHES, "loss": float(metrics["loss"]),
               "bn_launches": (bn_train.LAUNCHES_FW, bn_train.LAUNCHES_BW),
               "state": {k: v.detach().cpu().clone()
                         for k, v in state.model.state_dict().items()}}
        for _ in range(warm):
            state, _ = step(state, batch, draw_train(gen, state.model, STEP_BATCH, cfg))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fbank_cuda.LAUNCHES = 0
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(timed)]
        t0 = time.perf_counter()
        for start, end in events:
            start.record()
            state, metrics = step(state, batch, draw_train(gen, state.model, STEP_BATCH, cfg))
            end.record()
        torch.cuda.synchronize()
        out.update(wall_ms=(time.perf_counter() - t0) * 1e3 / timed,
                   device_ms=[a.elapsed_time(b) for a, b in events],
                   peak=torch.cuda.max_memory_allocated(), timed_launches=fbank_cuda.LAUNCHES,
                   last_loss=float(metrics["loss"]))
        del state
        eval_batch = train_batch(cfg, seed=6)
        probs, losses = build_eval_step(cfg)(train_state(sd), shard_batch(eval_batch, mesh))
        out["eval"] = (allgather_host(probs), allgather_host(losses))
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def dp_world(held: dict, held_loss: float, one: tuple[float, float], world: int,
             backend: str) -> dict:
    """(b) ``world`` ranks (2 under gloo on cuda:0, or one a card under
    NCCL), global batch 100, from (a)'s state and draws: the first step
    held to (a)'s at the JAX package's data-parallel bars and the running
    statistics within 1e-5, one fbank launch a rank a step, the timed steps
    beside (a)'s ``one`` (device ms, clips/s), and the eval step of the
    global batch, gathered, within 1e-5 of the one-process eval step.
    Returns each rank's launches in its held step."""
    root = tempfile.mkdtemp(prefix="psla_dp_step_")
    try:
        got = spawn_ranks(dp_step_rank, root, world, backend)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cfg = train_config()
    lr = psla_lr_schedule(STEP_LR, STEPS_PER_EPOCH, lrscheduler_start=10,
                          lrscheduler_decay=0.5, warmup=True)(START_STEP)
    warm, timed = dp_timing(backend)
    r0 = got[0]
    stats = [k for k in held if k.endswith(("running_mean", "running_var"))]
    params = [k for k in held if k not in stats]
    check(all(torch.equal(r0["state"][k], g["state"][k]) for g in got[1:] for k in held),
          "the ranks' replicas differ after a step")
    diff = param_diffs(r0["state"], held, params)
    stats_err = max_diff(r0["state"], held, stats)
    loss_err = abs(r0["loss"] - held_loss)
    print(f"(b) world {world} under {backend} on {where(world, backend)}, global batch "
          f"{STEP_BATCH}, {STEP_BATCH // world} a rank: fbank launches a rank in the held step "
          f"{[g['launches'] for g in got]}, in {timed} timed steps "
          f"{[g['timed_launches'] for g in got]}; vs (a)'s step: loss {loss_err:.3e} (bar "
          f"{DP_LOSS_ATOL}), parameters max {diff.max():.3e} (bar {DP_PARAM_LRS * lr}) mean "
          f"{diff.mean():.3e} (bar {DP_PARAM_MEAN}) p99 {np.percentile(diff, 99):.3e} (bar "
          f"{DP_PARAM_P99}), running statistics {stats_err:.3e} (bar {STATS_ATOL}); replicas "
          f"equal")
    check(all(g["launches"] == 1 and g["timed_launches"] == timed for g in got),
          f"world {world}: not one fbank launch a rank a step")
    print(f"(b) BatchNorm kernel launches a rank in the held step (synced BatchNorm): "
          f"{[g['bn_launches'] for g in got]}")
    check(all(tuple(g["bn_launches"]) == (0, 0) for g in got),
          f"world {world}: the synced BatchNorm launched the one-process kernels")
    check(loss_err <= DP_LOSS_ATOL and diff.max() <= DP_PARAM_LRS * lr
          and diff.mean() <= DP_PARAM_MEAN and np.percentile(diff, 99) <= DP_PARAM_P99
          and stats_err <= STATS_ATOL, f"world-{world} step off (a)'s")
    for rank, g in enumerate(got):
        print(f"(b) rank {rank}: {timed} steps after {warm}: wall "
              f"{g['wall_ms']:.2f} ms/step ({STEP_BATCH / g['wall_ms'] * 1e3:.1f} clips/s of "
              f"the global batch), device {np.mean(g['device_ms']):.2f} ms/step by CUDA "
              f"events (with the waits on the other ranks); peak memory "
              f"{g['peak'] / 2**30:.2f} GiB; last loss {g['last_loss']:.4f}; (a)'s one-card "
              f"step {one[0]:.2f} ms device, {one[1]:.1f} clips/s ({card()})")
    eval_batch = train_batch(cfg, seed=6)
    want, want_loss = build_eval_step(cfg)(train_state(seeded_state_dict(SEEDS[0])),
                                            eval_batch)
    errs = [max(float(np.abs(g["eval"][0] - want.cpu().numpy()).max()),
                float(np.abs(g["eval"][1] - want_loss.cpu().numpy()).max())) for g in got]
    print(f"(b) eval step of the global batch {STEP_BATCH}, gathered on each rank, vs the "
          f"one-process eval step: max abs err {errs} (bar {DP_EVAL_ATOL})")
    check(max(errs) <= DP_EVAL_ATOL, f"gathered eval off by {errs}")
    return {"launches_dp_train_step_per_rank": [g["launches"] for g in got]}


def audited(fn, exp_dir: str):
    """``fn()`` and the files under ``exp_dir`` this process opened for
    writing (``open`` and ``torch.save``, which writes a path from C++)."""
    written = []
    real_open, real_save = builtins.open, torch.save

    def record(file):
        if isinstance(file, (str, os.PathLike)):
            path = os.path.abspath(os.fspath(file))
            if path.startswith(exp_dir):
                written.append(os.path.relpath(path, exp_dir))

    def audited_open(file, mode="r", *args, **kwargs):
        if set(mode) & set("wax+"):
            record(file)
        return real_open(file, mode, *args, **kwargs)

    def audited_save(obj, f, *args, **kwargs):
        record(f)
        return real_save(obj, f, *args, **kwargs)

    builtins.open, torch.save = audited_open, audited_save
    try:
        return fn(), written
    finally:
        builtins.open, torch.save = real_open, real_save


def dp_cli_rank(rank: int, store: str, root: str, world: int, backend: str,
                base: list[str]):
    """(c) One rank of ``cli.run --num-devices N``: 2 epochs, then 1 epoch
    and ``--resume`` to 2, each run's fbank launches counted (set to 0 just
    before, read just after), what it sampled and drew, and the files it
    wrote."""
    join_group(rank, store, world, backend)
    try:
        out = {}
        runs = (("full", ["--exp-dir", os.path.join(root, "exp"), "--n-epochs", "2"]),
                ("first", ["--exp-dir", os.path.join(root, "resumed"), "--n-epochs", "1"]),
                ("second", ["--exp-dir", os.path.join(root, "resumed"), "--n-epochs", "2",
                            "--resume"]))
        for name, extra in runs:
            torch.cuda.synchronize()
            fbank_cuda.LAUNCHES = 0
            t0 = time.perf_counter()
            trainer, written = audited(lambda: run_cli(base + extra), root)
            torch.cuda.synchronize()
            out[name] = {"launches": fbank_cuda.LAUNCHES, "wall": time.perf_counter() - t0,
                         "indices": trainer.indices,
                         "drawn": {k: v.cpu() for k, v in trainer.drawn.items()},
                         "steps": trainer.steps_per_epoch,
                         "val_batches": trainer.val_loader.batches_per_epoch(),
                         "seconds": trainer.train_seconds, "written": written}
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def dp_trainer(root: str, train_json: str, val_json: str, world: int, backend: str) -> dict:
    """(c) ``cli.run --num-devices N`` (the ranks started here, each joining
    the group before ``cli.run``) at the audioset_full preset on phase 7's
    corpus: each rank's fbank launches equal its train steps plus its eval
    batches, only rank 0 writes, and the resumed run samples and draws what
    the uninterrupted one did, its losses within 2e-2."""
    base = ["--preset", "audioset_full", "--data-train", train_json, "--data-val", val_json,
            "--label-csv", assets.label_csv_for("audioset"), "--impretrain", "False",
            "--warmup", "False", "--wa_start", "1", "--wa_end", "2", "--eff_b", str(EFF_B),
            "--target_length", str(TARGET), "-b", str(STEP_BATCH), "--num-devices",
            str(world), "--device", DEVICE]
    got = spawn_ranks(dp_cli_rank, root, world, backend, base)
    full = got[0]["full"]
    spe, vb = full["steps"], full["val_batches"]
    # train steps and a validation each epoch, then weight averaging's
    want = {"full": 2 * spe + 3 * vb, "first": spe + 2 * vb, "second": spe + 2 * vb}
    for rank, g in enumerate(got):
        counts = {name: g[name]["launches"] for name in want}
        print(f"(c) cli.run --num-devices {world} ({backend}, {where(world, backend)}), rank "
              f"{rank}: {spe} steps an epoch of {STEP_BATCH // world} clips, {vb} val batches; fbank "
              f"launches {counts} (want {want}); uninterrupted run {g['full']['wall']:.1f} s, "
              f"epoch 2's train loop {g['full']['seconds'][2]:.3f} s "
              f"({spe * STEP_BATCH / g['full']['seconds'][2]:.1f} clips/s of the global "
              f"batch; {card()})")
        check(counts == want, f"rank {rank}: fbank launches {counts}, want {want}")
    check(not any(g[name]["written"] for g in got[1:] for name in want),
          f"ranks 1-{world - 1} wrote {[[g[n]['written'] for n in want] for g in got[1:]]}")
    written = set(got[0]["full"]["written"])
    for name in ("exp/result.csv", "exp/progress.json", "exp/wa_result.csv",
                 "exp/predictions/target.csv", "exp/predictions/predictions_2.csv",
                 "exp/models/epoch_2/checkpoint.pth.tmp", "exp/models/best/checkpoint.pth.tmp",
                 "exp/models/wa/checkpoint.pth.tmp"):
        check(name in written, f"rank 0 did not write {name}")
    print(f"(c) files written: rank 0 {len(written)} in the uninterrupted run, the other "
          f"ranks none")
    for rank, g in enumerate(got):
        for epoch, run in ((1, "first"), (2, "second")):
            check(np.array_equal(g["full"]["indices"][epoch], g[run]["indices"][epoch]),
                  f"rank {rank}, epoch {epoch}: the resumed run sampled other clips")
        resumed = {**g["first"]["drawn"], **g["second"]["drawn"]}
        check(sorted(resumed) == sorted(g["full"]["drawn"]), "the resumed run's steps")
        check(all(torch.equal(g["full"]["drawn"][k], resumed[k]) for k in resumed),
              f"rank {rank}: the resumed run drew otherwise")
    result = np.loadtxt(os.path.join(root, "exp", "result.csv"), delimiter=",")
    res2 = np.loadtxt(os.path.join(root, "resumed", "result.csv"), delimiter=",")
    diffs = np.abs(res2[1, 5:7] - result[1, 5:7])
    print(f"(c) resume: each rank's sampled indices and draws equal to the uninterrupted "
          f"run's; epoch 2 train and valid losses {result[1, 5]:.6f}, {result[1, 6]:.6f} vs "
          f"{res2[1, 5]:.6f}, {res2[1, 6]:.6f}: max diff {diffs.max():.3e} (bar "
          f"{TRAJECTORY_BAR})")
    check(result.shape == (2, 10) and bool(np.all(np.isfinite(result))), f"result {result}")
    check(diffs.max() <= TRAJECTORY_BAR, f"resumed losses off by {diffs.max()}")
    return {"launches_dp_trainer_run_per_rank": [g["full"]["launches"] for g in got]}


def dispatch_breakdown(engine: InferenceEngine, wav: np.ndarray, mean: np.ndarray,
                       lengths: np.ndarray, reps: int = 10) -> str:
    """Where a warm dispatch's time goes, for ROADMAP Queue 3 item 8. Over
    ``reps`` dispatches back to back (as ``dispatch_rate`` runs them), the
    host ms to issue each (``engine.issue``: every shard's input copies,
    fbank and forwards, queued from one thread) and to its fetched
    probabilities; then the shards' input copies alone, to their end, from
    pageable numpy memory and from pinned memory (host clock, means of
    ``reps``); then, over one profiled dispatch, each device's kernel
    launches and kernel ms (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    shards = np.array_split(np.arange(len(wav)), len(engine.devices))
    host = [(torch.from_numpy(wav[r]), torch.from_numpy(mean[r]), torch.from_numpy(lengths[r]))
            for r in shards]
    pinned = [tuple(t.pin_memory() for t in ts) for ts in host]

    def sync():
        for d in set(engine.devices):
            torch.cuda.synchronize(d)

    for _ in range(2):
        engine.batch_probs(wav, mean, lengths)
    issue, wall = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = engine.issue(wav, mean, lengths)
        t1 = time.perf_counter()
        [o.cpu() for o in outs]
        issue.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    copy_ms = {}
    for name, parts in (("pageable", host), ("pinned", pinned)):
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            for ts, d in zip(parts, engine.devices):
                for t in ts:
                    t.to(d, non_blocking=True)
        sync()
        copy_ms[name] = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.batch_probs(wav, mean, lengths)
    kernels: dict[int, list[float]] = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            kernels.setdefault(e.device_index, []).append(e.self_device_time_total / 1e3)
    per_device = ", ".join(f"cuda:{d} {len(v)} kernels {sum(v):.2f} ms"
                           for d, v in sorted(kernels.items())) or "not measured"
    return (f"issue {np.mean(issue):.2f} ms on the host ({min(issue):.2f}-{max(issue):.2f}), "
            f"fetched after {np.mean(wall):.2f} ms ({min(wall):.2f}-{max(wall):.2f}); the "
            f"input copies alone {copy_ms['pageable']:.3f} ms (pageable), "
            f"{copy_ms['pinned']:.3f} ms (pinned); profiled dispatch: {per_device}")


def dp_serving(world: int) -> int | None:
    """(d) Serving with ``world`` replicas at micro-batch 16, 2 members,
    float32. ``num_devices`` past the visible cards raises, naming them:
    with fewer cards (the one-card run) that is the check. With as many,
    ``num_devices=world`` places the replicas on cuda:0..world-1: within
    1e-5 of one device, one fbank launch a replica a dispatch (set to 0
    just before, read just after), both timed, and where a dispatch's time
    goes (``dispatch_breakdown``). Returns those launches, None without
    the cards."""
    names = make_name_dict(assets.label_csv_for("audioset"))
    config = PreprocessConfig(target_length=TARGET)
    members = [member(seeded_state_dict(s), torch.float32) for s in SEEDS]
    cards = torch.cuda.device_count()
    if cards < world:
        try:
            InferenceEngine(members, config, names, batch_size=BATCH, num_devices=world,
                            device=DEVICE)
        except ValueError as e:
            print(f"(d) --num-devices {world} on this machine: ValueError: {e}; the "
                  f"replicas are served with --data-parallel {world} on {world} cards")
            check(f"only {cards} devices are visible" in str(e), str(e))
            return None
        check(False, "num_devices past the cards did not raise")
    many = InferenceEngine(members, config, names, batch_size=BATCH, num_devices=world,
                           device=DEVICE)
    one = InferenceEngine(members, config, names, batch_size=BATCH, device=DEVICE)
    try:
        rng = np.random.default_rng(12)
        n = one.chunk_samples
        wav = np.stack([tones(rng, n) for _ in range(BATCH)])
        mean = wav.mean(axis=1).astype(np.float32)
        lengths = np.full(BATCH, n, np.int32)
        lengths[::5] = n // 3
        torch.cuda.synchronize()
        fbank_cuda.LAUNCHES = 0
        got = many.batch_probs(wav, mean, lengths)
        launches = fbank_cuda.LAUNCHES
        want = one.batch_probs(wav, mean, lengths)
        err = float(np.abs(got - want).max())
        rate1, ms1, _ = dispatch_rate(one, rng)
        rate2, ms2, _ = dispatch_rate(many, rng)
        split1 = dispatch_breakdown(one, wav, mean, lengths)
        split2 = dispatch_breakdown(many, wav, mean, lengths)
    finally:
        one.close()
        many.close()
    print(f"(d) serving, {world} replicas on {', '.join(map(str, many.devices))}, micro-batch "
          f"{BATCH}, {len(SEEDS)} members, float32: fbank launches in a dispatch {launches}; "
          f"vs one device: max abs err {err:.3e} (bar {DP_EVAL_ATOL}); {ms2:.2f} ms a "
          f"dispatch ({rate2:.1f} clips/s) against one device's {ms1:.2f} ms ({rate1:.1f} "
          f"clips/s) ({card()})")
    print(f"(d) one device's dispatch: {split1}")
    print(f"(d) {world} replicas' dispatch: {split2}")
    check(launches == world, f"{launches} fbank launches in a {world}-replica dispatch")
    check(err <= DP_EVAL_ATOL, f"{world}-replica serving off one device's by {err}")
    return launches


def dp_phase(b2: tuple[float, float] | None, world: int = DP_WORLD,
             backend: str = "gloo") -> dict:
    """Phase 12: data parallelism, (b)-(d) on ``world`` ranks under
    ``backend``. Returns the fbank kernel's launches on its paths."""
    t_phase = time.perf_counter()
    launches, held, held_loss, one = dp_world_one(b2)
    out = {"launches_dp_world1_step": launches}
    torch.cuda.empty_cache()
    out.update(dp_world(held, held_loss, one, world, backend))
    root = tempfile.mkdtemp(prefix="psla_dp_trainer_")
    try:
        train_json, val_json, _ = write_corpus(root)
        out.update(dp_trainer(root, train_json, val_json, world, backend))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches_dp_serving_dispatch"] = dp_serving(world)
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s; fbank launches {out}")
    return out


# ---------------------------------------------------------------- phase 13

# bfloat16 training (--dtype bfloat16) and int8 activation compression
# (--act-compress q8save|qdq) at the audioset_full widths, from phase 6's
# seeded weights, batch and draws. Parameters, BatchNorm statistics and Adam
# stay float32.
# int8 compression against the uncompressed bf16 step from the same start
# (the JAX package's bars, tests/test_qsave.py:121,127,132): q8save's forward
# is the uncompressed one, qdq's quantizes the depthwise inputs
COMPRESS_BARS = {"q8save": (1e-6, 0.999), "qdq": (5e-2, 0.9)}  # (loss atol, cosine)


def gradients(state) -> torch.Tensor:
    """The flat float64 gradient of the state's last step."""
    return torch.cat([p.grad.detach().double().flatten() for p in state.model.parameters()])


def bf16_held_steps(cfg: PreprocessConfig, batch: dict, sd: dict):
    """(a) and (b): the bf16 step through the kernel held to the plain
    fbank's, then with remat, then q8save and qdq from the same start
    against the uncompressed step. Returns (step, generator, the held
    state) for the timing."""
    state, loss, after, step, gen, draws, _ = step_held_to_plain(
        cfg, batch, lambda: train_state(sd, dtype=torch.bfloat16), "bf16 train step")
    check(all(t.dtype == torch.float32 for t in after.values()),
          "a bf16 step left a parameter or statistic outside float32")
    grads = gradients(state)
    params = [k for k, _ in state.model.named_parameters()]
    param_atol = 2 * state.schedule(START_STEP)

    remat = train_state(sd, remat=True, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    remat, metrics = step(remat, batch, draws)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    err = abs(float(metrics["loss"]) - loss)
    perr = max_diff(remat.model.state_dict(), after, params)
    print(f"bf16 remat=True: loss {err:.3e} from remat=False (bar {STEP_LOSS_ATOL}), "
          f"parameters {perr:.3e} (bar {param_atol}); peak memory {peak / 2**30:.2f} GiB")
    check(err <= STEP_LOSS_ATOL, f"bf16 remat loss off by {err}")
    check(perr <= param_atol, f"bf16 remat parameters off by {perr}")
    del remat

    for mode, (loss_atol, min_cos) in COMPRESS_BARS.items():
        other = train_state(sd, dtype=torch.bfloat16, act_compress=mode)
        other, metrics = step(other, batch, draws)
        g = gradients(other)
        err = abs(float(metrics["loss"]) - loss)
        cos = float(g @ grads / (g.norm() * grads.norm()))
        # both modes change the depthwise weight gradients (q8save reads the
        # int8 copy there): a step equal to the uncompressed one went round them
        moved = float((g - grads).norm() / grads.norm())
        print(f"bf16 --act-compress {mode}: loss {float(metrics['loss']):.6f}, {err:.3e} from "
              f"the uncompressed step (bar {loss_atol}), gradient cosine {cos:.6f} (bar "
              f"{min_cos}), gradient {moved:.3e} of its norm from the uncompressed one (> 0)")
        check(err <= loss_atol, f"{mode} loss off the uncompressed step's by {err}")
        check(cos > min_cos, f"{mode} gradient cosine {cos}")
        check(moved > 0, f"{mode}: the gradient is the uncompressed step's")
        del other
    return step, gen, state


def bf16_timing(cfg: PreprocessConfig, batch: dict, sd: dict, step, gen, state,
                f32: tuple[float, float], profile: bool):
    """(c) 2 warm-up and 10 timed steps of bf16, bf16 + q8save and bf16 +
    qdq, beside phase 6's float32 step (``f32``: device ms, clips/s)."""
    out = {}
    for mode in ("none", "q8save", "qdq"):
        if mode != "none":
            state = train_state(sd, dtype=torch.bfloat16, act_compress=mode)
        state, device_ms, wall_ms, peak, losses = timed_steps(step, state, batch, gen, cfg)
        out[mode] = (float(np.mean(device_ms)), STEP_BATCH / wall_ms * 1e3, peak)
        print(f"bf16 train step, --act-compress {mode}, {TIMED_STEPS} steps after "
              f"{WARM_STEPS} warm-up: device {np.mean(device_ms):.2f} ms/step (CUDA events; "
              f"{min(device_ms):.2f}-{max(device_ms):.2f}), wall {wall_ms:.2f} ms/step, "
              f"{STEP_BATCH / wall_ms * 1e3:.1f} clips/s; peak memory {peak / 2**30:.2f} GiB "
              f"(torch.cuda.max_memory_allocated); losses {losses[0]:.4f} .. {losses[-1]:.4f}")
        if profile and mode == "none":
            profile_train_step(state, step, batch, gen, cfg)
        del state
        torch.cuda.empty_cache()
    check(out["q8save"][2] < out["none"][2],
          f"q8save peaks at {out['q8save'][2]} bytes, not below bf16's {out['none'][2]}")
    print(f"bf16 steps beside phase 6's float32 step in this call ({f32[0]:.2f} ms, "
          f"{f32[1]:.1f} clips/s): " + ", ".join(
              f"{m} {ms:.2f} ms ({f32[0] / ms:.2f}x), {rate:.1f} clips/s, {peak / 2**30:.2f} GiB"
              for m, (ms, rate, peak) in out.items()) + f" ({card()})")


def bf16_backbones(cfg: PreprocessConfig, batch: dict):
    """(d) One bf16 train step of ResNet50 and of MobileNetV2 at batch
    STEP_BATCH, beside their float32 step from the same start and draws."""
    for name in BACKBONES:
        sd = seeded_state_dict(BACKBONE_SEEDS[0], model=name)
        losses = {}
        for dtype in (torch.float32, torch.bfloat16):
            state = train_state(sd, model_name=name, dtype=dtype)
            draws = draw_train(torch.Generator(device=DEVICE).manual_seed(0), state.model,
                               STEP_BATCH, cfg)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state, metrics = build_train_step(cfg)(state, batch, draws)
            losses[dtype] = float(metrics["loss"])
            peak = torch.cuda.max_memory_allocated()
            finite = all(bool(torch.isfinite(p).all()) for p in state.model.parameters())
            check(np.isfinite(losses[dtype]) and finite, f"{name} {dtype} step not finite")
            del state
            torch.cuda.empty_cache()
        print(f"{name} train step at batch {STEP_BATCH}: bf16 loss "
              f"{losses[torch.bfloat16]:.6f} beside float32 {losses[torch.float32]:.6f} from "
              f"the same start ({abs(losses[torch.bfloat16] - losses[torch.float32]):.3e} "
              f"apart); bf16 peak memory {peak / 2**30:.2f} GiB")


def bf16_trainer(root: str) -> int:
    """(e) ``cli.run --dtype bfloat16 --act-compress q8save`` at the
    audioset_full preset for 1 epoch on phase 7's corpus writer: the fbank
    launches are the train steps plus every eval batch; the CSVs finite; the
    wa checkpoint (float32) serves through ``InferenceEngine``. Returns the
    launches."""
    train_json, val_json, _ = write_corpus(root)
    exp = os.path.join(root, "exp_bf16")
    argv = ["--preset", "audioset_full", "--data-train", train_json, "--data-val", val_json,
            "--data-eval", val_json, "--label-csv", assets.label_csv_for("audioset"),
            "--exp-dir", exp, "--warmup", "False", "--n-epochs", "1", "--wa_start", "1",
            "--wa_end", "1", "--impretrain", "False", "--target_length", str(TARGET), "-b",
            str(STEP_BATCH), "--dtype", "bfloat16", "--act-compress", "q8save",
            "--device", DEVICE]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fbank_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    run = run_cli(argv)
    torch.cuda.synchronize()
    launches, wall = fbank_cuda.LAUNCHES, time.perf_counter() - t0
    check(run.config.dtype == "bfloat16" and run.config.act_compress == "q8save",
          f"the trainer ran {run.config.dtype} / {run.config.act_compress}")
    spe, vb = run.steps_per_epoch, run.val_loader.batches_per_epoch()
    eb = run.eval_loader.batches_per_epoch()
    want = spe + vb + vb + 2 * (vb + eb) + eb  # as fsd_trainer counts them
    secs = run.train_seconds[1]
    print(f"psla-torch-train --dtype bfloat16 --act-compress q8save (cli.run, audioset_full: "
          f"{arch(run._new_model())}, T={TARGET}, batch {STEP_BATCH}): 1 epoch of {spe} steps "
          f"in {secs:.3f} s of train loop ({spe * STEP_BATCH / secs:.1f} clips/s), {wall:.2f} s "
          f"in all; fbank launches {launches} (train steps {spe} + eval batches {want - spe}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card()})")
    check(launches == want, f"bf16 trainer: {launches} fbank launches, want {want}")
    for name in ("result.csv", "predictions/target.csv", "predictions/predictions_1.csv",
                 "wa_result.csv", "best_single_result.csv", "ensemble_result.csv"):
        values = np.loadtxt(os.path.join(exp, name), delimiter=",")
        check(values.size > 0 and bool(np.all(np.isfinite(values))), f"{name}: not finite")
    sd = load_variables(os.path.join(exp, "models", "wa"))
    check(all(t.dtype == torch.float32 for t in sd.values()), "a bf16 run saved non-float32")
    model = create_model("efficientnet", label_dim=N_CLASS, eff_b=run.config.eff_b,
                         head_num=run.config.att_head)
    model.load_state_dict(sd)
    engine = InferenceEngine([model], PreprocessConfig(target_length=TARGET),
                             make_name_dict(assets.label_csv_for("audioset")), batch_size=4,
                             device=DEVICE)
    try:
        probs = engine.predict(decode_wav(open(os.path.join(root, "val_0000.wav"), "rb")
                                          .read())[0], SR)
    finally:
        engine.close()
    check(probs.shape == (N_CLASS,) and bool(np.all(np.isfinite(probs))),
          "the bf16 wa checkpoint served non-finite probabilities")
    print(f"bf16 wa checkpoint served (float32 engine): probabilities "
          f"{probs.min():.4f}..{probs.max():.4f}")
    return launches


def bf16_phase(f32: tuple[float, float], profile: bool) -> dict:
    """Phase 13: bfloat16 training and int8 activation compression. Returns
    the fbank kernel's launches on its paths and the steps' numbers."""
    t_phase = time.perf_counter()
    cfg = train_config()
    batch = train_batch(cfg)
    sd = seeded_state_dict(SEEDS[0])
    step, gen, state = bf16_held_steps(cfg, batch, sd)
    torch.cuda.empty_cache()
    bf16_timing(cfg, batch, sd, step, gen, state, f32, profile)
    del state
    torch.cuda.empty_cache()
    bf16_backbones(cfg, batch)
    root = tempfile.mkdtemp(prefix="psla_bf16_")
    try:
        trainer_launches = bf16_trainer(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s")
    return {"launches_bf16_step": 1, "launches_bf16_trainer_run": trainer_launches}


# ---------------------------------------------------------------- phase 14

# (a) Train-mode BatchNorm given a gradient in odd strides (ROADMAP Queue 3
# item 12): on the CPU, F.batch_norm's backward is wrong for a channels-last
# gradient with a non-canonical stride on a size-1 last dimension, which
# EffNetAttention's pooling hands back at T' = 1; models/layers.BatchNorm
# passes its gradient on in its output's own strides.
BN_SHAPE, BN_ODD_STRIDES = (4, 16, 2, 1), (32, 1, 16, 32)
ONE_STEP_TARGET = 32  # frames: one time step left after the last stride
# each leaf's gradient within 1e-6 of its norm plus 1e-7 of the whole
# gradient's (tests/test_torch_qsave.py's bars): a leaf whose gradient is
# zero but for rounding (a bias that a train-mode BatchNorm follows) has no
# relative bar of its own
ONE_STEP_GRAD_RTOL, ONE_STEP_GRAD_FLOOR = 1e-6, 1e-7
# (b) and (c) Ensembles across ranks: E seeds on W ranks, ensemble_layout's
# rows. The held steps run at batch 50 (two ranks share the card in (b)).
ROWS_BATCH = 50


def odd_strided(g: torch.Tensor) -> torch.Tensor:
    return torch.empty_strided(g.shape, BN_ODD_STRIDES, dtype=g.dtype,
                               device=g.device).copy_(g)


def batchnorm_grads(x: torch.Tensor, g: torch.Tensor, port: bool) -> list[torch.Tensor]:
    """y, dx, dweight and dbias of a train-mode batch normalization of ``x``
    (float32 weight and bias) backward from ``g``: raw ``F.batch_norm``, or
    the port's ``BatchNorm``."""
    c = x.shape[1]
    x = x.clone().requires_grad_()
    weight = torch.linspace(0.5, 1.5, c, device=x.device)
    bias = torch.linspace(-0.1, 0.1, c, device=x.device)
    if port:
        bn = BatchNorm(c).to(x.device).train()
        with torch.no_grad():
            bn.weight.copy_(weight)
            bn.bias.copy_(bias)
        weight, bias = bn.weight, bn.bias
        y = bn(x)
    else:
        weight.requires_grad_()
        bias.requires_grad_()
        y = F.batch_norm(x, torch.zeros(c, device=x.device), torch.ones(c, device=x.device),
                         weight, bias, True, 0.01, 1e-3)
    y.backward(g)
    return [y.detach(), x.grad, weight.grad, bias.grad]


def leaf_grads(state) -> dict[str, torch.Tensor]:
    return {k: p.grad.detach().double().clone() for k, p in state.model.named_parameters()}


def batchnorm_strides() -> int:
    """(a) Raw ``F.batch_norm`` under the odd strides against the same
    gradient made contiguous, for a float32 input (cuDNN) and a bf16 input
    with float32 parameters (PyTorch's own kernels): reported. The port's
    BatchNorm: bit for bit in both. Then the B2 train step at
    ``--target_length 32`` against the same step with the backbone output's
    gradient made contiguous by a hook (cuDNN deterministic for both):
    each leaf's gradient within ``ONE_STEP_GRAD_RTOL`` of its norm plus
    ``ONE_STEP_GRAD_FLOOR`` of the whole gradient's. Returns the held step's
    fbank launches."""
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    x32 = torch.randn(BN_SHAPE, generator=gen, device=DEVICE)
    g32 = torch.randn(BN_SHAPE, generator=gen, device=DEVICE)
    for dtype in (torch.float32, torch.bfloat16):
        x, g = x32.to(dtype), g32.to(dtype)
        want, got = (batchnorm_grads(x, h, port=False) for h in (g, odd_strided(g)))
        rel = [float((a.double() - b.double()).norm() / b.double().norm())
               for a, b in zip(got[1:], want[1:])]
        port = [batchnorm_grads(x, h, port=True) for h in (g, odd_strided(g))]
        equal = all(torch.equal(a, b) for a, b in zip(*port))
        print(f"(a) raw F.batch_norm on the card, {dtype} input, float32 parameters, "
              f"{list(BN_SHAPE)} with gradient strides {BN_ODD_STRIDES} vs contiguous: "
              f"relative error dx {rel[0]:.3e}, dweight {rel[1]:.3e}, dbias {rel[2]:.3e} "
              f"({'shares' if max(rel) > 1e-3 else 'does not share'} the CPU's fault); the "
              f"port's BatchNorm bit-equal: {equal}")
        check(equal, f"the port's BatchNorm in {dtype} depends on its gradient's strides")

    cfg = PreprocessConfig(fbank=FbankConfig(precision="high"), target_length=ONE_STEP_TARGET,
                           freq_mask=48, time_mask=8, mixup_rate=0.5)
    batch = train_batch(cfg, seed=13)
    sd = seeded_state_dict(SEEDS[0])
    step = build_train_step(cfg)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        launches, grads = {}, {}
        for name in ("hooked", "as is"):
            state = train_state(sd)
            if name == "hooked":
                def contiguous(module, args, out):
                    out.register_hook(lambda g: g.clone(memory_format=torch.contiguous_format))

                state.model.effnet.register_forward_hook(contiguous)
            draws = draw_train(torch.Generator(device=DEVICE).manual_seed(0), state.model,
                               STEP_BATCH, cfg)
            torch.cuda.synchronize()
            fbank_cuda.LAUNCHES = 0
            state, _ = step(state, batch, draws)
            torch.cuda.synchronize()
            launches[name] = fbank_cuda.LAUNCHES
            grads[name] = leaf_grads(state)
            del state
    finally:
        torch.backends.cudnn.deterministic = deterministic
    want = grads["hooked"]
    whole = float(torch.sqrt(sum((g ** 2).sum() for g in want.values())))
    off = {k: float((grads["as is"][k] - want[k]).norm()) for k in want}
    used = max(off[k] / (ONE_STEP_GRAD_RTOL * float(want[k].norm())
                         + ONE_STEP_GRAD_FLOOR * whole) for k in want)
    own = max(off[k] / max(float(want[k].norm()), 1e-300) for k in want)
    equal = all(torch.equal(grads["as is"][k], want[k]) for k in want)
    print(f"(a) B{EFF_B} train step at --target_length {ONE_STEP_TARGET} (T' = 1), batch "
          f"{STEP_BATCH}: fbank launches {launches['as is']}; each leaf's gradient vs the step "
          f"with the backbone output's gradient made contiguous: largest share of its bar "
          f"({ONE_STEP_GRAD_RTOL} of the leaf's norm + {ONE_STEP_GRAD_FLOOR} of the whole "
          f"gradient's) {used:.3e}, of the leaf's own norm {own:.3e}; bit-equal: {equal}")
    check(launches["as is"] == 1, f"{launches['as is']} fbank launches in the T'=1 step")
    check(used <= 1.0, f"T'=1 gradients off by {used} of their bar")
    return launches["as is"]


def one_process_ensemble(seeds: int, cfg: PreprocessConfig, batch: dict) -> dict:
    """The one-process ensemble step at ``seeds`` members from phase 11's
    seeded weights, each drawing from ``step_generator(0, START_STEP,
    member=i)``: the seed losses and each member's state on the host. A
    member's step reads no other member, so the first E of them are the
    E-member step's."""
    state = EnsembleState([train_state(seeded_state_dict(s)) for s in ENSEMBLE_SEEDS[:seeds]])
    draws = [draw_train(step_generator(0, START_STEP, DEVICE, member=i),
                        state.members[0].model, len(batch["wav"]), cfg) for i in range(seeds)]
    state, metrics = make_ensemble_train_step(cfg)(state, batch, draws)
    return {"seed_loss": metrics["seed_loss"].cpu(),
            "members": [{k: v.detach().cpu().clone() for k, v in m.model.state_dict().items()}
                        for m in state.members]}


def timed_loop(run, timed: int) -> dict:
    """``run()`` (one step) ``WARM_STEPS`` times, then ``timed`` times
    between CUDA events: device ms of each, wall ms a step, peak memory."""
    for _ in range(WARM_STEPS):
        run()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(timed)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for start, end in events:
        start.record()
        run()
        end.record()
    torch.cuda.synchronize()
    return {"wall_ms": (time.perf_counter() - t0) * 1e3 / timed,
            "device_ms": [a.elapsed_time(b) for a, b in events],
            "peak": torch.cuda.max_memory_allocated()}


# (c) --profile: device time by group, with the collectives' kernels apart
RANK_GROUPS = (("NCCL collectives (with the waits on the other ranks)", r"nccl"),
               *KERNEL_GROUPS)


def profiled(run) -> dict[str, float]:
    """Device ms by ``RANK_GROUPS`` over one ``run()``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return device_groups(prof.key_averages(), RANK_GROUPS)[0]


def rows_steps_rank(world: int, seed_counts: list[int], timed: int,
                    profile: bool = False) -> dict:
    """This rank's part of (b) or (c): for each E in ``seed_counts``, its
    row's members from phase 11's seeded weights placed on the row, one
    step of its share of the batch (the fbank launches counted: E_local),
    then ``timed`` steps timed after WARM_STEPS. With ``profile`` ((c)),
    the same steps timed with the seed losses' gather over every rank
    (``gather_seeds``) left out, as a trainer that gathers them once a
    logging interval would run them, and the data-parallel single-model
    step over every rank at the same clips a rank (phase 12's path), each
    with one profiled step."""
    cfg = train_config()
    out = {}
    for seeds in seed_counts:
        rows = ensemble_layout(seeds, world, dist.get_rank(), world)[0]
        mesh = make_mesh(device=DEVICE, ensemble=rows)
        members = local_members(seeds, mesh)
        held = {"state": place_members(EnsembleState(
            [train_state(seeded_state_dict(ENSEMBLE_SEEDS[i])) for i in members], mesh))}
        step = make_ensemble_train_step(cfg, "BCE", mesh)
        batch = shard_batch(train_batch(cfg, batch=ROWS_BATCH), mesh)

        def run():
            state = held["state"]
            held["state"], held["metrics"] = step(state, batch, [
                draw_train(step_generator(0, state.step, DEVICE, member=i),
                           state.members[0].model, ROWS_BATCH, cfg) for i in members])

        torch.cuda.synchronize()
        fbank_cuda.LAUNCHES = 0
        run()
        torch.cuda.synchronize()
        got = {"launches": fbank_cuda.LAUNCHES, "members": list(members), "row": mesh.row,
               "seed_loss": held["metrics"]["seed_loss"].cpu(),
               "state": [{k: v.detach().cpu().clone() for k, v in m.model.state_dict().items()}
                         for m in held["state"].members]}
        if timed:
            got["as is"] = timed_loop(run, timed)
        if profile:
            got["as is"]["groups"] = profiled(run)
            gather = ensemble_module.gather_seeds
            ensemble_module.gather_seeds = lambda local, mesh: local
            try:
                got["deferred"] = timed_loop(run, timed)
                got["deferred"]["groups"] = profiled(run)
            finally:
                ensemble_module.gather_seeds = gather
        out[seeds] = got
        del held
        torch.cuda.empty_cache()
    if profile:
        out["data-parallel"] = dp_step_timed(cfg, ROWS_BATCH // mesh.world * world, timed)
    return out


def dp_step_timed(cfg: PreprocessConfig, batch_size: int, timed: int) -> dict:
    """(c) --profile: phase 12's data-parallel single-model step over every
    rank at global batch ``batch_size``, timed and profiled as the rows'."""
    mesh = make_mesh(device=DEVICE)
    held = {"state": replicate_state(train_state(seeded_state_dict(ENSEMBLE_SEEDS[0])), mesh)}
    step = build_train_step(cfg, "BCE", mesh)
    batch = shard_batch(train_batch(cfg, batch=batch_size), mesh)
    gen = torch.Generator(device=DEVICE).manual_seed(0)

    def run():
        state = held["state"]
        held["state"], _ = step(state, batch, draw_train(gen, state.model, batch_size, cfg))

    got = timed_loop(run, timed)
    got["groups"] = profiled(run)
    got["batch"] = batch_size
    del held
    torch.cuda.empty_cache()
    return got


def rows_cli_rank(root: str, base: list[str], tool: list[str]) -> dict:
    """This rank's part of (b)'s tools: ``cli.run --ensemble-seeds 2
    --num-devices 2`` for 1 epoch, then ``--resume`` to 2, then
    ``tools/ensemble --num-devices 2`` on the run's best members: each
    one's fbank launches (set to 0 just before, read just after) and the
    files it wrote."""
    out = {}
    runs = (("first", lambda: cli.run(base + ["--n-epochs", "1"])),
            ("resumed", lambda: cli.run(base + ["--n-epochs", "2", "--resume"])),
            ("tool", lambda: ensemble_tool.run(tool)))
    for name, fn in runs:
        torch.cuda.synchronize()
        fbank_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        result, written = audited(fn, root)
        torch.cuda.synchronize()
        out[name] = {"launches": fbank_cuda.LAUNCHES, "wall": time.perf_counter() - t0,
                     "written": written, "result": result}
    return out


def rows_rank(rank: int, store: str, root: str, world: int, backend: str,
              seed_counts: list[int], timed: int, base: list[str] | None,
              tool: list[str] | None, profile: bool = False):
    """One rank of (b) or (c): the held steps, then (with ``base``) the
    trainer and the ensemble tool; its results in ``{root}/rank{rank}.pt``."""
    join_group(rank, store, world, backend)
    try:
        out = {"steps": rows_steps_rank(world, seed_counts, timed, profile)}
        if base:
            out["cli"] = rows_cli_rank(root, base, tool)
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def rows_steps(got: list[dict], ref: dict, world: int, backend: str, timed: int) -> list[int]:
    """(b)/(c) Each E of the ranks' held steps against the one-process
    ensemble step on the same batch and draws (``ref``: E -> its seed
    losses and members) at phase 12's bars: every seed's loss, each
    member's parameters and running statistics; each member's replicas in
    a row equal; E_local fbank launches a rank. Returns each rank's
    launches in its held steps."""
    lr = psla_lr_schedule(STEP_LR, STEPS_PER_EPOCH, lrscheduler_start=10,
                          lrscheduler_decay=0.5, warmup=True)(START_STEP)
    launches = []
    for seeds, want in ref.items():
        rows, _, per_row = ensemble_layout(seeds, world, 0, world)
        steps = [g["steps"][seeds] for g in got]
        loss_err = max(float((r["seed_loss"] - want["seed_loss"]).abs().max()) for r in steps)
        diffs, stats_err = [], 0.0
        for rank, r in enumerate(steps):
            first = steps[rank - rank % per_row]
            check(all(torch.equal(a[k], b[k]) for a, b in zip(r["state"], first["state"])
                      for k in a), f"E={seeds}: rank {rank}'s replicas differ from its row's")
            for i, member in zip(r["members"], r["state"]):
                stats = [k for k in member if k.endswith(("running_mean", "running_var"))]
                params = [k for k in member if k not in stats]
                diffs.append(param_diffs(member, want["members"][i], params))
                stats_err = max(stats_err, max_diff(member, want["members"][i], stats))
        diff = np.concatenate(diffs)
        counts = [r["launches"] for r in steps]
        launches += counts
        e_local = seeds // rows
        print(f"(b/c) E={seeds} on {world} ranks under {backend} ({where(world, backend)}): "
              f"{rows} row(s) of {per_row} rank(s), {e_local} member(s) a rank, batch "
              f"{ROWS_BATCH} ({ROWS_BATCH // per_row} a rank); fbank launches a rank "
              f"{counts}; vs the one-process ensemble step: seed losses {loss_err:.3e} (bar "
              f"{DP_LOSS_ATOL}), parameters max {diff.max():.3e} (bar {DP_PARAM_LRS * lr}) "
              f"mean {diff.mean():.3e} (bar {DP_PARAM_MEAN}) p99 "
              f"{np.percentile(diff, 99):.3e} (bar {DP_PARAM_P99}), running statistics "
              f"{stats_err:.3e} (bar {STATS_ATOL}); replicas equal")
        check(counts == [e_local] * world, f"E={seeds}: fbank launches {counts}")
        check(loss_err <= DP_LOSS_ATOL and diff.max() <= DP_PARAM_LRS * lr
              and diff.mean() <= DP_PARAM_MEAN and np.percentile(diff, 99) <= DP_PARAM_P99
              and stats_err <= STATS_ATOL, f"E={seeds} on {world} ranks off one process's")
        for rank, r in enumerate(steps if timed else []):
            for variant in ("as is", "deferred"):
                if variant in r:
                    print_rank_timing(f"(c) E={seeds}, rank {rank} (row {r['row']}), "
                                      f"{variant}", r[variant], ROWS_BATCH, timed)
    for rank, g in enumerate(got):
        if "data-parallel" in g["steps"]:
            t = g["steps"]["data-parallel"]
            print_rank_timing(f"(c) phase 12's data-parallel step over the {world} ranks, "
                              f"rank {rank}", t, t["batch"], timed)
    return launches


def print_rank_timing(what: str, t: dict, batch: int, timed: int):
    """A rank's ``timed_loop`` result (and its profiled step's groups)."""
    print(f"{what}: {timed} steps after {WARM_STEPS}: device "
          f"{np.mean(t['device_ms']):.2f} ms/step (CUDA events, with the waits on the other "
          f"ranks; {min(t['device_ms']):.2f}-{max(t['device_ms']):.2f}), wall "
          f"{t['wall_ms']:.2f} ms/step ({batch / t['wall_ms'] * 1e3:.1f} clips/s of the "
          f"global batch of {batch}), peak {t['peak'] / 2**30:.2f} GiB ({card()})")
    if "groups" in t:
        total = sum(t["groups"].values())
        print(f"  one profiled step, device {total:.2f} ms: " + "; ".join(
            f"{name} {ms:.2f}" for name, ms in sorted(t["groups"].items(),
                                                        key=lambda kv: -kv[1])))


def rows_cli(got: list[dict], root: str, exp: str, tool: list[str]) -> dict:
    """(b) ``psla-torch-train --ensemble-seeds 2 --num-devices 2`` at the
    audioset_full preset on phase 7's corpus, global batch 50 (each rank
    trains its member on the whole batch): its fbank launches its steps
    plus its eval batches, only rank 0 writes, the stacked checkpoint
    holds both seeds; ``tools/ensemble --num-devices 2`` within 1e-5 of
    one process's. Returns the launches."""
    world = len(got)
    spe, vb = TRAIN_CLIPS // ROWS_BATCH, -(-VAL_CLIPS // ROWS_BATCH)
    shard = -(-VAL_CLIPS // world)  # the tool's rows a rank, in batches of ROWS_BATCH / W
    # a member's steps, the epoch's validation and weight averaging's
    want = {"first": spe + 2 * vb, "resumed": spe + 2 * vb,
            "tool": -(-shard // (ROWS_BATCH // world))}
    runs = [g["cli"] for g in got]
    for rank, g in enumerate(runs):
        counts = {name: g[name]["launches"] for name in want}
        print(f"(b) rank {rank}: cli.run --ensemble-seeds 2 --num-devices {world} (gloo, "
              f"{where(world, 'gloo')}): {spe} steps an epoch of {ROWS_BATCH} clips (its "
              f"member on the whole batch), fbank launches {counts} (want {want}); 1 epoch "
              f"{g['first']['wall']:.1f} s, resumed epoch 2 {g['resumed']['wall']:.1f} s, "
              f"tools/ensemble {g['tool']['wall']:.1f} s ({card()})")
        check(counts == want, f"rank {rank}: fbank launches {counts}, want {want}")
    check(not any(g[name]["written"] for g in runs[1:] for name in want),
          f"rank 1 wrote {[runs[1][n]['written'] for n in want]}")
    written = set(runs[0]["first"]["written"])
    for name in ("exp/result.csv", "exp/seed_result.csv.tmp",
                 "exp/predictions/predictions_1_seed1.csv",
                 "exp/models/epoch_1/checkpoint.pth.tmp",
                 "exp/models/best_seed1/checkpoint.pth.tmp"):
        check(name in written, f"rank 0 did not write {name}")
    ckpt = torch.load(os.path.join(exp, "models", "epoch_2", "checkpoint.pth"),
                      map_location="cpu", weights_only=True)
    check(ckpt["seeds"] == 2 and ckpt["step"] == 2 * spe and len(ckpt["optimizer"]) == 2
          and all(v.shape[0] == 2 for v in ckpt["model"].values()),
          f"stacked epoch_2: seeds {ckpt['seeds']}, step {ckpt['step']}")
    result = np.loadtxt(os.path.join(exp, "result.csv"), delimiter=",")
    check(result.shape == (2, 10) and bool(np.all(np.isfinite(result))), f"result {result}")
    check(runs[0]["resumed"]["result"] == runs[1]["resumed"]["result"],
          "the ranks' summaries differ")
    one = ensemble_tool.run(tool + ["--out-dir", os.path.join(root, "tool_one")])
    errs = [float(np.abs(
        np.loadtxt(os.path.join(root, "tool_ranks", f"predictions_{i}.csv"), delimiter=",")
        - np.loadtxt(os.path.join(root, "tool_one", f"predictions_{i}.csv"), delimiter=",")
    ).max()) for i in range(2)]
    print(f"(b) files written: rank 0 {len(written)} in the first run, rank 1 none; the "
          f"stacked epoch_2 checkpoint holds 2 seeds at step {ckpt['step']}; tools/ensemble "
          f"on 2 ranks vs one process: predictions {errs} (bar {ENSEMBLE_ATOL}), mAP "
          f"{runs[0]['tool']['result']['ensemble']['mAP']:.4f} vs {one['ensemble']['mAP']:.4f}")
    check(max(errs) <= ENSEMBLE_ATOL, f"tools/ensemble on 2 ranks off by {errs}")
    return {"launches_rows_trainer_run_per_rank": [g["first"]["launches"] for g in runs],
            "launches_rows_tool_per_rank": [g["tool"]["launches"] for g in runs]}


def rows_phase(world: int | None = None, profile: bool = False) -> dict:
    """Phase 14: (a) the T'=1 gradient; (b) ensembles across 2 ranks under
    gloo on one card: E=2 and E=4 held to one process, the trainer and its
    resume, the ensemble tool, all in one spawn. With ``world``
    (``--data-parallel N``): (c) alone, E=2 on N ranks under NCCL, one a
    card, rows of N / 2, timed (``profile``: beside the step without the
    seed losses' gather and phase 12's step, each with a profiled step).
    Returns the fbank kernel's launches on its paths."""
    t_phase = time.perf_counter()
    cfg = train_config()
    batch = train_batch(cfg, batch=ROWS_BATCH)
    if world:
        ref = {2: one_process_ensemble(2, cfg, batch)}
        torch.cuda.empty_cache()
        root = tempfile.mkdtemp(prefix="psla_rows_")
        try:
            got = spawn_ranks(rows_rank, root, world, "nccl", [2], TIMED_STEPS, None, None,
                              profile)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        out = {"launches_rows_step_per_rank": rows_steps(got, ref, world, "nccl",
                                                         TIMED_STEPS)}
        print(f"phase 14 (c): {time.perf_counter() - t_phase:.1f} s; fbank launches {out}")
        return out
    out = {"launches_t1_step": batchnorm_strides()}
    four = one_process_ensemble(4, cfg, batch)
    ref = {e: {"seed_loss": four["seed_loss"][:e], "members": four["members"][:e]}
           for e in (2, 4)}
    torch.cuda.empty_cache()
    world = 2
    root = tempfile.mkdtemp(prefix="psla_rows_")
    try:
        train_json, val_json, _ = write_corpus(root)
        exp = os.path.join(root, "exp")
        base = ["--preset", "audioset_full", "--data-train", train_json, "--data-val",
                val_json, "--label-csv", assets.label_csv_for("audioset"), "--exp-dir", exp,
                "--impretrain", "False", "--warmup", "False", "--wa_start", "1", "--wa_end",
                "2", "--eff_b", str(EFF_B), "--target_length", str(TARGET), "-b",
                str(ROWS_BATCH), "--ensemble-seeds", "2", "--num-devices", str(world),
                "--device", DEVICE]
        tool = [*(os.path.join(exp, "models", f"best_seed{i}") for i in range(2)),
                "--data-eval", val_json, "--label-csv", assets.label_csv_for("audioset"),
                "--eff_b", str(EFF_B), "--n_class", str(N_CLASS), "--target_length",
                str(TARGET), "--batch-size", str(ROWS_BATCH), "--device", DEVICE]
        got = spawn_ranks(rows_rank, root, world, "gloo", [2, 4], 0, base,
                          tool + ["--out-dir", os.path.join(root, "tool_ranks"),
                                  "--num-devices", str(world)])
        out["launches_rows_step_per_rank"] = rows_steps(got, ref, world, "gloo", 0)
        out.update(rows_cli(got, root, exp, tool))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s; fbank launches {out}")
    return out


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--profile", action="store_true",
                   help="also print device time by kernel for one dispatch and one "
                        "train step; with --data-parallel N, phase 14 (c)'s breakdown")
    p.add_argument("--data-parallel", type=int, default=None, metavar="N",
                   help="run phases 12 and 14 (c) alone on N cards under NCCL, one rank "
                        "a card, held to the one-process step on one card")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    header()
    if args.data_parallel:
        cards = torch.cuda.device_count()
        check(cards >= args.data_parallel, f"{cards} cards for --data-parallel "
                                           f"{args.data_parallel}")
        dp_phase(None, args.data_parallel, "nccl")
        torch.cuda.empty_cache()
        rows_phase(args.data_parallel, args.profile)
        print(f"total {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cards}}))
        return 0
    build()
    record = kernel_phase()
    record["launches"] = serving_phase(args.profile)
    records = [record] + mbconv_phase()
    torch.cuda.empty_cache()
    bn_record = bn_phase()
    records.append(bn_record)
    torch.cuda.empty_cache()
    record["launches_per_train_step"], step_clips_s, step_ms, bn_step = training_phase(
        args.profile)
    bn_record["launches_per_train_step"] = list(bn_step)
    bn_record["launches"] = sum(bn_step)
    torch.cuda.empty_cache()
    record["launches_trainer_run"], record["launches_per_epoch"] = trainer_phase(
        args.profile, step_clips_s)
    torch.cuda.empty_cache()
    record["launches_eval_side"], _ = eval_phase(args.profile)
    torch.cuda.empty_cache()
    record.update(fsd_phase(step_clips_s))
    torch.cuda.empty_cache()
    record.update(backbones_phase((step_ms, step_clips_s), args.profile))
    torch.cuda.empty_cache()
    record.update(ensemble_phase((step_ms, step_clips_s)))
    torch.cuda.empty_cache()
    record.update(dp_phase((step_ms, step_clips_s)))
    torch.cuda.empty_cache()
    record.update(bf16_phase((step_ms, step_clips_s), args.profile))
    torch.cuda.empty_cache()
    record.update(rows_phase())
    for r in records:
        check(r["launches"] > 0, f"kernel {r['name']} was not launched on its path")
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
