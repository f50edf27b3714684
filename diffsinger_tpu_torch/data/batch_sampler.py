"""Length-bucketed batch sampler (counterpart of
diffsinger_tpu/data/batch_sampler.py, one replica).

Similar-size sorting on a frame grid, frame-budget batching, and shuffling
seeded by (seed, epoch), so the same seed and epoch give the JAX sampler's
batches. With one replica the JAX sampler's batch shuffle permutes along the
replica axis and so keeps the order; this sampler has none. Batch counts are
padded to a multiple of the gradient accumulation. Rank sharding comes with
distributed training.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np


def batch_by_size(indices: np.ndarray, num_frames_fn, max_batch_frames: int = 80000,
                  max_batch_size: int = 48,
                  required_batch_count_multiple: int = 1) -> List[List[int]]:
    """Group roughly length-sorted indices into batches under a frame budget
    and an item budget; the batch count is rounded up to a multiple of
    ``required_batch_count_multiple`` by splitting the largest batches."""
    batches: List[List[int]] = []
    batch: List[int] = []
    batch_frames = 0
    for idx in indices:
        size = num_frames_fn(idx)
        assert size <= max_batch_frames, (
            f"sentence at index {idx} exceeds max_batch_frames ({size} > {max_batch_frames})")
        if batch and (batch_frames + size > max_batch_frames or len(batch) + 1 > max_batch_size):
            batches.append(batch)
            batch, batch_frames = [], 0
        batch.append(int(idx))
        batch_frames += size
    if batch:
        batches.append(batch)
    r = len(batches) % required_batch_count_multiple
    if r:
        for i in sorted(range(len(batches)), key=lambda i: -len(batches[i]))[
                :required_batch_count_multiple - r]:
            b = batches[i]
            if len(b) >= 2:
                batches[i] = b[:len(b) // 2]
                batches.append(b[len(b) // 2:])
    return batches


class DsBatchSampler:
    def __init__(self, sizes: Sequence[int], max_batch_frames: int, max_batch_size: int, *,
                 frame_count_grid: int = 6, required_batch_count_multiple: int = 1,
                 sort_by_similar_size: bool = True, shuffle_sample: bool = False,
                 seed: int = 0):
        self.sizes = np.asarray(sizes)
        self.max_batch_frames = max_batch_frames
        self.max_batch_size = max_batch_size
        self.frame_count_grid = frame_count_grid
        self.required_batch_count_multiple = required_batch_count_multiple
        self.sort_by_similar_size = sort_by_similar_size
        self.shuffle_sample = shuffle_sample
        self.seed = seed
        self.epoch = 0
        self.batches: Optional[List[List[int]]] = None

    def _form_batches(self) -> List[List[int]]:
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.shuffle_sample:
            indices = rng.permutation(len(self.sizes))
            if self.sort_by_similar_size:
                grid = self.frame_count_grid
                sizes = (np.round(self.sizes[indices] / grid) * grid).clip(grid, None)
                indices = indices[np.argsort(sizes, kind="mergesort")]
        else:
            indices = np.arange(len(self.sizes))
        batches = batch_by_size(indices, lambda i: int(self.sizes[i]),
                                max_batch_frames=self.max_batch_frames,
                                max_batch_size=self.max_batch_size)
        if not batches:
            raise RuntimeError("There is not enough batch to assign to each node.")
        assignment = list(range(len(batches)))
        multiple = self.required_batch_count_multiple
        if multiple > 1 and len(assignment) % multiple:
            floored = len(assignment)
            target = math.ceil(floored / multiple) * multiple
            assignment += [assignment[(i + self.epoch * multiple) % floored]
                           for i in range(target - floored)]
        return [list(batches[i]) for i in assignment]

    def __iter__(self):
        if self.batches is None:
            self.batches = self._form_batches()
        return iter(self.batches)

    def __len__(self):
        if self.batches is None:
            self.batches = self._form_batches()
        return len(self.batches)

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.batches = self._form_batches()
