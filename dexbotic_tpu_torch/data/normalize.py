"""Streaming normalization statistics.

Reimplements the reference's RunningStats (streaming mean/std/min/max plus
histogram-based q01/q99 with re-binning on range growth) and its
norm_stats.json schema so checkpoints remain interchangeable
(/root/reference/dexbotic/data/utils/normalize.py).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np


@dataclasses.dataclass
class NormStats:
    mean: np.ndarray
    std: np.ndarray
    q01: np.ndarray | None = None
    q99: np.ndarray | None = None
    min: np.ndarray | None = None
    max: np.ndarray | None = None

    def to_dict(self) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = None if v is None else np.asarray(v).tolist()
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "NormStats":
        kw = {}
        for f in dataclasses.fields(cls):
            v = d.get(f.name)
            kw[f.name] = None if v is None else np.asarray(v, dtype=np.float64)
        return cls(**kw)


class RunningStats:
    """Streaming per-dimension stats over batches of vectors."""

    NUM_BINS = 5000

    def __init__(self):
        self._count = 0
        self._mean = None
        self._mean_sq = None
        self._min = None
        self._max = None
        self._hist = None  # [D, BINS]
        self._edges = None  # [D, BINS+1]

    def update(self, batch: np.ndarray) -> None:
        batch = np.asarray(batch, dtype=np.float64)
        if batch.ndim == 1:
            batch = batch.reshape(-1, 1)
        n, d = batch.shape
        if self._count == 0:
            self._mean = batch.mean(0)
            self._mean_sq = (batch**2).mean(0)
            self._min = batch.min(0)
            self._max = batch.max(0)
            self._hist = np.zeros((d, self.NUM_BINS))
            self._edges = np.stack(
                [
                    np.linspace(self._min[i] - 1e-10, self._max[i] + 1e-10, self.NUM_BINS + 1)
                    for i in range(d)
                ]
            )
        else:
            if d != self._mean.size:
                raise ValueError("dimension mismatch in RunningStats.update")
            new_min, new_max = batch.min(0), batch.max(0)
            changed = np.any(new_max > self._max) or np.any(new_min < self._min)
            self._min = np.minimum(self._min, new_min)
            self._max = np.maximum(self._max, new_max)
            if changed:
                self._rebin()

        self._count += n
        bm = batch.mean(0)
        bms = (batch**2).mean(0)
        self._mean += (bm - self._mean) * (n / self._count)
        self._mean_sq += (bms - self._mean_sq) * (n / self._count)
        for i in range(d):
            h, _ = np.histogram(batch[:, i], bins=self._edges[i])
            self._hist[i] += h

    def _rebin(self):
        for i in range(self._hist.shape[0]):
            new_edges = np.linspace(self._min[i], self._max[i], self.NUM_BINS + 1)
            new_hist, _ = np.histogram(
                self._edges[i][:-1], bins=new_edges, weights=self._hist[i]
            )
            self._hist[i] = new_hist
            self._edges[i] = new_edges

    def _quantile(self, q: float) -> np.ndarray:
        target = q * self._count
        out = []
        for i in range(self._hist.shape[0]):
            cs = np.cumsum(self._hist[i])
            idx = int(np.searchsorted(cs, target))
            out.append(self._edges[i][idx])
        return np.array(out)

    def get_statistics(self) -> NormStats:
        if self._count < 2:
            raise ValueError("need at least 2 samples")
        var = np.maximum(0.0, self._mean_sq - self._mean**2)
        return NormStats(
            mean=self._mean,
            std=np.sqrt(var),
            q01=self._quantile(0.01),
            q99=self._quantile(0.99),
            min=self._min,
            max=self._max,
        )


def serialize_json(norm_stats: dict[str, NormStats]) -> str:
    return json.dumps(
        {"norm_stats": {k: v.to_dict() for k, v in norm_stats.items()}}, indent=2
    )


def deserialize_json(data: str) -> dict[str, NormStats]:
    raw = json.loads(data)["norm_stats"]
    return {k: NormStats.from_dict(v) for k, v in raw.items()}


def save(directory, norm_stats: dict[str, NormStats]) -> None:
    path = pathlib.Path(directory) / "norm_stats.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(serialize_json(norm_stats))


def load(directory) -> dict[str, NormStats]:
    path = pathlib.Path(directory) / "norm_stats.json"
    if not path.exists():
        raise FileNotFoundError(f"norm stats not found: {path}")
    return deserialize_json(path.read_text())
