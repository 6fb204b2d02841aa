"""Balanced sampling: per-sample weights and with-replacement samplers
(port of ``psla_tpu/data/sampler.py``; numpy draws, so the same seed and
epoch give the JAX package's index sequences).

Weight formula from the reference's weight generator
(src/gen_weight_file.py:50-58): label_weight[c] = 1000 / (count[c] + 0.01);
sample_weight[i] = sum of label_weight over the clip's labels. Training then
draws indices with replacement proportional to sample_weight, the semantics
of torch's WeightedRandomSampler as used in src/run.py:82-89.
"""

from __future__ import annotations

import numpy as np

from psla_tpu_torch.data.datafiles import Datafile, load_datafile


def compute_sample_weights(datafile: Datafile) -> np.ndarray:
    """[N] sampling weights (gen_weight_file.py:50-58 formula)."""
    counts = np.zeros(datafile.num_classes, dtype=np.float64)
    per_sample = [datafile.label_indices(i) for i in range(len(datafile))]
    for idxs in per_sample:
        counts[idxs] += 1.0
    label_weight = 1000.0 / (counts + 0.01)
    weights = np.zeros(len(datafile), dtype=np.float64)
    for i, idxs in enumerate(per_sample):
        weights[i] = label_weight[idxs].sum()
    return weights


def gen_weight_file(datafile_json: str, label_csv: str, out_path: str | None = None):
    """Writes the weights as {datafile}_weight.csv (read like run.py:84)."""
    df = load_datafile(datafile_json, label_csv)
    weights = compute_sample_weights(df)
    if out_path is None:
        out_path = datafile_json[:-5] + "_weight.csv"
    np.savetxt(out_path, weights, delimiter=",")
    return out_path


class WeightedSampler:
    """With-replacement weighted index sampler (one epoch = N draws)."""

    def __init__(self, weights: np.ndarray, seed: int = 0):
        w = np.asarray(weights, dtype=np.float64)
        if not (np.all(w >= 0) and w.sum() > 0):
            raise ValueError("sample weights must be >= 0 with a positive sum")
        self._p = w / w.sum()
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._n = len(w)

    def epoch(self, num_samples: int | None = None, epoch: int | None = None) -> np.ndarray:
        """One epoch of draws. With ``epoch`` given, the draw is a pure
        function of (seed, epoch), which a resumed run needs; without it,
        one stateful stream."""
        n = self._n if num_samples is None else num_samples
        rng = self._rng if epoch is None else np.random.default_rng((self._seed, epoch))
        return rng.choice(self._n, size=n, replace=True, p=self._p)


class UniformSampler:
    """Shuffled without-replacement sampler (the bal=False path,
    run.py:90-94).

    Several hosts construct it with the SAME seed: each epoch is one global
    permutation partitioned across hosts by stride (torch
    DistributedSampler semantics), so the hosts' samples are disjoint and
    together cover the dataset."""

    def __init__(self, n: int, seed: int = 0, host_id: int = 0, num_hosts: int = 1):
        self._n = n
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._host_id = host_id
        self._num_hosts = num_hosts

    def epoch(self, num_samples: int | None = None, epoch: int | None = None) -> np.ndarray:
        rng = self._rng if epoch is None else np.random.default_rng((self._seed, epoch))
        perm = rng.permutation(self._n)
        if self._num_hosts > 1:
            perm = perm[self._host_id::self._num_hosts]
        if num_samples is not None:
            perm = perm[:num_samples]
        return perm
