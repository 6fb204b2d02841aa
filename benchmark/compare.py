"""The comparisons that decide ``correct``, and nothing else.

Training: each checked step's loss, the first step's gradient as Adam took
it (read from the program's first moment after one step), and each
parameter's change after the checked steps, against the reference's from
the same weights, batches and draws. Norms are compared leaf by leaf: the
gap between the program's norm of a leaf and the reference's, over the
reference's norm of that leaf or of the median leaf, whichever is larger
(some gradients are all but zero); the number is the worst leaf's. A leaf
whose reference gradient is under a thousandth of the median leaf's moves
under Adam by rounding alone and is left out of the change.
"""

from __future__ import annotations

import statistics

import torch

# a leaf's reference gradient below this share of the median leaf's is
# rounding: its change is not compared
STILL = 1e-3


def norms(tensors: dict[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def norm_gap(got: dict[str, float], want: dict[str, float], skip=()) -> tuple[float, str]:
    """The worst leaf's |got - want| / max(want, the median leaf's want),
    and that leaf."""
    keys = [k for k in want if k not in skip]
    median = statistics.median(want[k] for k in keys)
    gaps = {k: abs(got[k] - want[k]) / max(want[k], median, 1e-30) for k in keys}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def still_leaves(ref_grads: dict[str, float]) -> set[str]:
    median = statistics.median(ref_grads.values())
    return {k for k, v in ref_grads.items() if v < STILL * median}


def train_checks(program: dict, reference: dict, limits: dict) -> tuple[list, list]:
    """``program``: ``losses`` (floats), ``grads`` and ``changes`` (norms by
    leaf); ``reference``: ``train_steps``'s tensors. -> ([(name, value,
    limit)], lines naming the worst leaves)."""
    ref_losses = [float(x) for x in reference["losses"]]
    ref_grads, ref_changes = norms(reference["grads"]), norms(reference["changes"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(program["losses"], ref_losses))
    still = still_leaves(ref_grads)
    grad_gap, grad_leaf = norm_gap(program["grads"], ref_grads)
    change_gap, change_leaf = norm_gap(program["changes"], ref_changes, still)
    notes = [f"losses: program {program['losses']}, reference {ref_losses}",
             f"grad_gap's leaf {grad_leaf}: program {program['grads'][grad_leaf]!r}, "
             f"reference {ref_grads[grad_leaf]!r}",
             f"change_gap's leaf {change_leaf}: program {program['changes'][change_leaf]!r}, "
             f"reference {ref_changes[change_leaf]!r}; {len(still)} still leaves left out"]
    return [("loss_gap", loss_gap, limits["loss_gap"]),
            ("grad_gap", grad_gap, limits["grad_gap"]),
            ("change_gap", change_gap, limits["change_gap"])], notes

