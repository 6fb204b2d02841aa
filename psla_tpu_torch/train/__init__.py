"""The train and eval steps (port of ``psla_tpu/train/``): the PSLA
optimizer, schedule and losses (optim.py), the training state (state.py)
and the steps (step.py)."""
