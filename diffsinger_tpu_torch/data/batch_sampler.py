"""Length-bucketed batch sampler (counterpart of
diffsinger_tpu/data/batch_sampler.py).

Similar-size sorting on a frame grid, frame-budget batching, shuffling seeded
by (seed, epoch), and the rank-strided assignment of batches to replicas with
its leftovers and repeats, so the same seed, epoch, replica count and rank
give the JAX sampler's batches. Batch counts are padded to a multiple of the
gradient accumulation.
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
    """Batches of one epoch for one rank of ``num_replicas``.

    The batches are formed once for every rank (shuffle, similar-size sort,
    frame budget) and dealt out by an assignment matrix: rank r takes every
    ``num_replicas``-th batch (with ``shuffle_batch``, each column of the
    matrix permuted), one of the leftover batches if there is one for it,
    else a repeat of its own (so every rank has as many batches), and
    repeats up to a multiple of ``required_batch_count_multiple``.
    :meth:`all_rank_batches` gives every rank's list from one forming pass.
    """

    def __init__(self, sizes: Sequence[int], max_batch_frames: int, max_batch_size: int, *,
                 num_replicas: int = 1, rank: int = 0, frame_count_grid: int = 6,
                 required_batch_count_multiple: int = 1, sort_by_similar_size: bool = True,
                 shuffle_sample: bool = False, shuffle_batch: bool = False, seed: int = 0):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"Invalid rank {rank}, should be in [0, {num_replicas - 1}]")
        self.sizes = np.asarray(sizes)
        self.max_batch_frames = max_batch_frames
        self.max_batch_size = max_batch_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.frame_count_grid = frame_count_grid
        self.required_batch_count_multiple = required_batch_count_multiple
        self.sort_by_similar_size = sort_by_similar_size
        self.shuffle_sample = shuffle_sample
        self.shuffle_batch = shuffle_batch
        self.seed = seed
        self.epoch = 0
        self.batches: Optional[List[List[int]]] = None

    def _form_shared(self):
        """(batches, assignment matrix [replicas, n], leftover batch ids)."""
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
        if len(batches) < self.num_replicas:
            raise RuntimeError("There is not enough batch to assign to each node.")
        floored = (len(batches) // self.num_replicas) * self.num_replicas
        if self.shuffle_batch:
            leftovers = (rng.permutation(len(batches) - floored) + floored).tolist()
        else:
            leftovers = list(range(floored, len(batches)))
        matrix = np.arange(floored).reshape(-1, self.num_replicas).transpose()
        if self.shuffle_batch:
            matrix = rng.permuted(matrix, axis=0)
        return batches, matrix, leftovers

    def _rank_batches(self, batches, matrix, leftovers, rank: int) -> List[List[int]]:
        assignment = matrix[rank].tolist()
        floored = len(assignment)
        if rank < len(leftovers):
            assignment.append(leftovers[rank])
            floored += 1
        elif leftovers:
            assignment.append(assignment[self.epoch % floored])
        multiple = self.required_batch_count_multiple
        if multiple > 1 and len(assignment) % multiple:
            target = math.ceil(len(assignment) / multiple) * multiple
            assignment += [assignment[(i + self.epoch * multiple) % floored]
                           for i in range(target - len(assignment))]
        return [list(batches[i]) for i in assignment]

    def all_rank_batches(self) -> List[List[List[int]]]:
        """Every rank's batches of the epoch, from one forming pass."""
        shared = self._form_shared()
        return [self._rank_batches(*shared, r) for r in range(self.num_replicas)]

    def _form_batches(self) -> List[List[int]]:
        return self._rank_batches(*self._form_shared(), self.rank)

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
