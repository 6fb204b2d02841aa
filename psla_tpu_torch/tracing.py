"""Named spans inside the port, recorded by ``torch.profiler``.

``span(name)`` opens the profiler range ``psla.<name>`` while a torch
profiler is recording, and is one shared no-op context otherwise: with no
profiler it reads one flag and makes no profiler call. The ranges are the
profiler's own events, so they are kept in its memory, written with its
trace, and lie on one timeline with the CUDA runtime calls and the kernels
they launched (``args.correlation`` ties a kernel to its call). A span
adds no synchronize, no CUDA event and no host copy.

The profiler follows the thread that started it and autograd's threads
working for it; a span opened on another thread (the prefetch producer's)
is recorded when the profiler records all threads
(``torch.profiler._ExperimentalConfig(profile_all_threads=True)``, as
the trainer's ``--profile-steps`` trace does).
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

# every span the port opens
SPANS = (
    "psla.train.step",  # train.step.build_train_step's train_step, whole
    "psla.train.preprocess",  # the int16 dequantize and preprocess_train
    "psla.train.forward",  # the train-mode forward and the loss
    "psla.train.backward",  # zero_grad and loss.backward()
    "psla.train.exchange",  # the gradients' all-reduce, on W > 1 ranks
    "psla.train.optimizer",  # set_lr and Adam's step
    "psla.train.draws",  # train.step.draw_train
    "psla.prefetch.wait",  # data.device_prefetch: the step waiting for a batch
    "psla.prefetch.stage",  # data.device_prefetch's producer staging a batch
    # inside the forward of models/spectrogram_transformer.ASTModel
    "psla.ast.embed",  # patches, the cls and dist tokens, pos_embed
    "psla.ast.attention",  # a block's LN1, qkv, attention and proj (one a block)
    "psla.ast.mlp",  # a block's LN2, fc1, GELU and fc2 (one a block)
    "psla.ast.head",  # the final LayerNorm, the tokens' mean, mlp_head, sigmoid
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """The profiler range ``psla.<name>`` while a torch profiler records,
    else a shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function("psla." + name)
