"""Offline checkpoint weight averaging on the GPU (port of
``psla_tpu/tools/weight_averaging.py``; reference:
src/ensemble/weight_averaging.py).

    python -m psla_tpu_torch.tools.weight_averaging ckpt_16 ... ckpt_30 \\
        --data-eval eval.json --label-csv labels.csv [--device cuda]

Averages the state_dicts of any list of checkpoints (the formats
``models.convert.load_variables`` reads) and evaluates the averaged model
through the eval step (``tools/ensemble.predict``). The mean is the true
1/N; the reference's in-training variant divides by N+1
(traintest.py:302-315).
"""

from __future__ import annotations

from typing import Iterable, Mapping

import torch

from psla_tpu_torch.models.convert import load_variables
from psla_tpu_torch.tools.ensemble import (
    check_heads,
    eval_parser,
    eval_setup,
    member_model,
    predict,
    scores,
)


def average_state_dicts(state_dicts: Iterable[Mapping[str, torch.Tensor]]
                        ) -> dict[str, torch.Tensor]:
    """The 1/N mean of N state_dicts, taken one at a time.

    Floating entries (parameters and BatchNorm's running statistics) are
    summed in float64 and the mean is cast back to each entry's dtype (the
    in-training ``train.loop.Trainer.weight_average`` sums in float32, as
    the JAX trainer does). An integer entry is not averaged: it keeps the
    last state_dict's value, as the trainer keeps it. The port's
    state_dicts hold none (``models.convert.normalize_state_dict`` drops
    the reference's ``num_batches_tracked``)."""
    total: dict[str, torch.Tensor] | None = None
    count = 0
    for sd in state_dicts:
        if total is None:
            total = {k: v.double() if v.is_floating_point() else v for k, v in sd.items()}
        else:
            if sd.keys() != total.keys():
                raise ValueError("the checkpoints hold different entries: "
                                 f"{sorted(set(sd) ^ set(total))[:4]}")
            total = {k: total[k] + v.double() if v.is_floating_point() else v
                     for k, v in sd.items()}
        dtypes = {k: v.dtype for k, v in sd.items()}
        count += 1
    if total is None:
        raise ValueError("no state_dicts to average")
    return {k: (v / count).to(dtypes[k]) if dtypes[k].is_floating_point else v
            for k, v in total.items()}


def weight_average_eval(
    checkpoints: list[str],
    loader,
    pre_config,
    model_name: str = "efficientnet",
    n_class: int = 527,
    eff_b: int = 2,
    device: str | torch.device = "cuda",
    att_head: int | None = None,
) -> dict:
    """Average the checkpoints and score the averaged model: {"mAP",
    "mAUC", "state_dict", "predictions"}. ``att_head``, where given, must
    be every checkpoint's head count."""
    def state_dicts():
        for c in checkpoints:
            sd = load_variables(c)
            check_heads(c, sd, att_head, model_name)
            yield sd

    state_dict = average_state_dicts(state_dicts())
    pred, target = predict(member_model(state_dict, model_name, n_class, eff_b), loader,
                           pre_config, device)
    m, a = scores(pred, target)
    print(f"weight-averaged {len(checkpoints)} ckpts: mAP {m:.6f} AUC {a:.6f}")
    return {"mAP": m, "mAUC": a, "state_dict": state_dict, "predictions": pred}


def main(argv=None) -> int:
    args = eval_parser(__doc__.split("\n")[0]).parse_args(argv)
    loader, pre, n_class = eval_setup(args)
    weight_average_eval(args.checkpoints, loader, pre, model_name=args.model,
                        n_class=n_class, eff_b=args.eff_b, device=args.device,
                        att_head=args.att_head)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
