"""psla_tpu_torch: the PyTorch/CUDA port of psla_tpu for NVIDIA Hopper.

A package of its own beside ``psla_tpu`` (the JAX reference). It imports
torch, numpy and scipy, and nothing of JAX or of ``psla_tpu``. Module names
follow the JAX package so each counterpart is easy to find; public functions
keep its layouts (waveforms ``[B, N]``, log-mel ``[B, T, F]``, probabilities
``[B, C]``).

Ported so far: the serving path (``tools/serve.py``) with its frontend,
EfficientNet-attention models, long-clip inference, and the hand-written
CUDA kernels (``csrc/``); the training step and the trainer
(``psla-torch-train``); and the eval side (``tools/``: predict, the
checkpoint ensemble, weight averaging, normalization statistics,
checkpoint conversion, the ``torch.export`` artifact, and ImageNet
initialisation from a local file, ``models/pretrained.py``). Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
