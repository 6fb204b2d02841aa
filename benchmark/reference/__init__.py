"""The benchmark's plain reference: the kaldi log-mel fbank, the PSLA
training recipe's pieces and one module per model family, in plain PyTorch.

Nothing here imports the program under test (``psla_tpu_torch``), JAX or
the JAX package. The benchmark makes the weights and inputs and hands the
same ones to the program and to these functions.
"""
