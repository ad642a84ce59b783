"""Episode-ordered batch schedules for memory training, and the
length-grouped schedule of packed training (port of
dexbotic_tpu/exp/mem_trainer.py; host-side Python, no tensors).

Batches keep in-episode frame order, so that a memory bank sees an
episode's frames in sequence.  Modes of :func:`episode_batches`:

* 'stream': one episode at a time, its frames in order; a batch is
  consecutive frames of one episode.
* 'group': each batch is ``group_size`` consecutive frames of one episode.
* 'parallel_stream': B parallel episode streams; row b of batch i is the
  i-th frame of stream b's current episode, and a finished stream takes the
  next episode.

``shard`` / ``num_shards`` split the episodes across processes
(episodes[rank::world]).  Both schedules draw from ``random.Random(seed)``,
as the JAX package does, so the two give the same indices.
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Iterator


def build_episode_index(dataset) -> dict:
    """Episode key (dataset index, file index) -> its dataset indices in frame order."""
    eps = defaultdict(list)
    for i, (ds, f, frame) in enumerate(dataset.global_index):
        eps[(ds, f)].append((frame, i))
    return {k: [i for _, i in sorted(v)] for k, v in eps.items()}


def episode_batches(dataset, batch_size: int, mode: str = "parallel_stream",
                    group_size: int = 8, seed: int = 42, shard: int = 0,
                    num_shards: int = 1) -> Iterator[list]:
    """Yields a list of (dataset index, is the episode's first frame) a batch."""
    eps = build_episode_index(dataset)
    keys = sorted(eps.keys())
    rng = random.Random(seed)
    rng.shuffle(keys)
    keys = keys[shard::num_shards]

    if mode in ("stream", "group"):
        step = batch_size if mode == "stream" else group_size
        for k in keys:
            idxs = eps[k]
            for s in range(0, len(idxs), step):
                yield [(i, s + j == 0) for j, i in enumerate(idxs[s: s + step])]
    elif mode == "parallel_stream":
        queue = list(keys)
        streams = [None] * batch_size  # each: [the episode's indices, next position]
        while True:
            batch = []
            for b in range(batch_size):
                if streams[b] is None or streams[b][1] >= len(streams[b][0]):
                    if not queue:
                        return
                    streams[b] = [eps[queue.pop(0)], 1]
                    batch.append((streams[b][0][0], True))
                else:
                    idxs, pos = streams[b]
                    batch.append((idxs[pos], False))
                    streams[b][1] = pos + 1
            yield batch
    else:
        raise ValueError(mode)


def length_grouped_batches(lengths: list[int], batch_size: int, seed: int = 42,
                           group_factor: int = 8) -> list:
    """Batches of samples of similar lengths, shuffled (NaVILA's
    length-grouped sampler): the indices sorted by length into mega-groups
    of ``batch_size * group_factor``, each shuffled and cut into batches (a
    mega-group's short tail dropped), then the batches shuffled."""
    rng = random.Random(seed)
    order = sorted(range(len(lengths)), key=lambda i: lengths[i])
    mega = batch_size * group_factor
    batches = []
    for s in range(0, len(order), mega):
        group = order[s: s + mega]
        rng.shuffle(group)
        for b in range(0, len(group) - batch_size + 1, batch_size):
            batches.append(group[b: b + batch_size])
    rng.shuffle(batches)
    return batches
