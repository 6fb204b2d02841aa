"""Command-line tools of the port: the HTTP inference server (serve.py),
long-clip prediction (predict.py), the checkpoint ensemble (ensemble.py),
weight averaging (weight_averaging.py), normalization statistics
(compute_stats.py), checkpoint conversion (convert_ckpt.py), the
torch.export artifact (export.py), the balanced-sampling weights
(gen_weight_file.py), data preparation (prep_audioset.py, prep_fsd.py),
label enhancement (label_enhancement.py), the experiment monitor
(watch.py), the smoke and flagship rehearsals (smoke.py, flagship.py) and
the release tools (fetch_pretrained.py, verify_release.py)."""
