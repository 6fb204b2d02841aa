"""Command-line tools of the port: the HTTP inference server (serve.py),
long-clip prediction (predict.py), the checkpoint ensemble (ensemble.py),
weight averaging (weight_averaging.py), normalization statistics
(compute_stats.py), checkpoint conversion (convert_ckpt.py), the
torch.export artifact (export.py) and the balanced-sampling weights
(gen_weight_file.py)."""
