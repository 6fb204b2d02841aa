"""One-command published-release verification: fetch -> convert -> predict
-> eval (``psla-torch-verify-release``; port of
``psla_tpu/tools/verify_release.py``).

The reference publishes trained checkpoints as Dropbox downloads with
headline mAPs (pretrained_models/README.md:5) and a torch-only loading
recipe (src/ensemble/ensemble.py:35-68). Where the network is reachable,

    psla-torch-verify-release as_mdl_0 --eval-data eval.json --label-csv ...

downloads the ``.pth``, converts it to the port's checkpoint
(``tools/fetch_pretrained``), predicts one WAV through
``psla-torch-predict`` (``tools/predict.run``), scores the eval set through
``tools/ensemble``, compares the mAP with the published number, and
prints ONE JSON verdict line. The model runs on ``--device`` (the card by
default).

Every stage can be fed locally:

  --url file://...          the download (any urllib scheme)
  --wav clip.wav            the probe clip (default: a synthetic tone)
  --eval-data/--label-csv   a fixture or a real eval set (omit: stage skipped)
  --expected-map/--tolerance override the README mAP / acceptance band
  --eff_b/--att_head/--target_length/--batch-size  model and eval shape
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from psla_tpu_torch.tools.fetch_pretrained import ZOO, fetch_and_convert

# Acceptance band around the published mAP. Released checkpoints are
# deterministic, but eval-set realizations differ (AudioSet eval churn,
# decode/resample paths), so exact equality is not expected.
DEFAULT_TOLERANCE = 0.02


def verify(
    name: str,
    out_dir: str,
    url: str | None = None,
    wav: str | None = None,
    eval_data: str | None = None,
    label_csv: str | None = None,
    expected_map: float | None = None,
    tolerance: float = DEFAULT_TOLERANCE,
    eff_b: int = 2,
    att_head: int = 4,
    target_length: int | None = None,
    batch_size: int = 16,
    keep_pth: bool = False,
    device: str = "cuda",
) -> dict:
    """Run the release-verification chain; returns the verdict dict."""
    entry = ZOO.get(name, {})
    n_class = entry.get("n_class", 527)
    target_length = target_length or entry.get("target_length", 1056)
    if expected_map is None:
        expected_map = entry.get("map")

    verdict: dict = {"model": name, "stages": {}, "ok": True}

    def fail(stage: str, err: Exception) -> dict:
        verdict["stages"][stage] = {"ok": False, "error": f"{type(err).__name__}: {err}"}
        verdict["ok"] = False
        print(json.dumps(verdict))
        return verdict

    # ---- stage 1: download + convert (DataParallel 'module.' strip +
    # '_fc' drop, the reference's own loading normalization)
    try:
        ckpt = fetch_and_convert(name, out_dir, url=url, keep_pth=keep_pth)
    except Exception as e:
        return fail("fetch_convert", e)
    verdict["stages"]["fetch_convert"] = {"ok": True, "ckpt": ckpt}

    # ---- stage 2: single-wav predict through psla-torch-predict
    try:
        from psla_tpu_torch import assets
        from psla_tpu_torch.data.datafiles import make_name_dict
        from psla_tpu_torch.data.wav import write_wav
        from psla_tpu_torch.tools import predict as predict_tool

        probe_csv = label_csv or (assets.fsd50k_label_csv() if n_class == 200
                                  else assets.audioset_label_csv())
        names = make_name_dict(probe_csv)
        if len(names) != n_class:
            raise ValueError(f"label csv has {len(names)} classes, model has {n_class}")
        if wav is None:
            t = np.arange(10 * 16000) / 16000
            probe = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
            wav = os.path.join(tempfile.mkdtemp(prefix="psla_verify_"), "probe.wav")
            write_wav(wav, probe, 16000)
        probs = predict_tool.run([
            wav, "--ckpt", ckpt, "--label-csv", probe_csv, "--eff_b", str(eff_b),
            "--att_head", str(att_head), "--target_length", str(target_length),
            "--top_k", "1", "--device", device,
        ])[wav]
        if probs.shape != (n_class,) or not np.all(np.isfinite(probs)):
            raise ValueError(f"bad prediction: shape={probs.shape}")
        if probs.min() < 0.0 or probs.max() > 1.0:
            raise ValueError("predictions outside [0, 1]")
        top = int(np.argmax(probs))
        verdict["stages"]["predict"] = {
            "ok": True, "wav": wav,
            "top1": names.get(top, str(top)),
            "top1_prob": round(float(probs[top]), 4),
        }
    except Exception as e:
        return fail("predict", e)

    # ---- stage 3: eval-set mAP vs the published README number
    if eval_data is None:
        verdict["stages"]["eval"] = {"ok": True, "skipped": "no --eval-data given"}
    else:
        try:
            from psla_tpu_torch.data.datafiles import load_datafile
            from psla_tpu_torch.data.loader import AudioLoader, LoaderConfig
            from psla_tpu_torch.frontend.pipeline import PreprocessConfig
            from psla_tpu_torch.tools.ensemble import ensemble_eval

            pre = PreprocessConfig(target_length=target_length).eval_variant()
            loader = AudioLoader(
                load_datafile(eval_data, label_csv or probe_csv),
                LoaderConfig(batch_size=batch_size,
                             buffer_samples=pre.fbank.buffer_length(target_length),
                             drop_remainder=False),
                shuffle=False,
            )
            res = ensemble_eval([ckpt], loader, pre, n_class=n_class, eff_b=eff_b,
                                device=device, att_head=att_head)
            measured = float(res["models"][0]["mAP"])
            stage = {"ok": True, "mAP": round(measured, 4),
                     "expected_mAP": expected_map, "tolerance": tolerance}
            if expected_map is not None:
                stage["within_tolerance"] = bool(abs(measured - expected_map) <= tolerance)
                if not stage["within_tolerance"]:
                    verdict["ok"] = False
            verdict["stages"]["eval"] = stage
        except Exception as e:
            return fail("eval", e)

    print(json.dumps(verdict))
    return verdict


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("model", help=f"zoo name: {sorted(ZOO)}")
    p.add_argument("--out", default="pretrained")
    p.add_argument("--url", default=None,
                   help="override the download URL (mirror / file://)")
    p.add_argument("--wav", default=None, help="probe clip for the predict "
                   "stage (default: synthetic 440 Hz tone)")
    p.add_argument("--eval-data", default=None)
    p.add_argument("--label-csv", default=None)
    p.add_argument("--expected-map", type=float, default=None)
    p.add_argument("--tolerance", type=float, default=DEFAULT_TOLERANCE)
    p.add_argument("--eff_b", type=int, default=2)
    p.add_argument("--att_head", type=int, default=4)
    p.add_argument("--target_length", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--keep-pth", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)
    verdict = verify(
        args.model, args.out, url=args.url, wav=args.wav,
        eval_data=args.eval_data, label_csv=args.label_csv,
        expected_map=args.expected_map, tolerance=args.tolerance,
        eff_b=args.eff_b, att_head=args.att_head,
        target_length=args.target_length, batch_size=args.batch_size,
        keep_pth=args.keep_pth, device=args.device,
    )
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
