"""Batch generator with multi-scale augmentation and host prefetch.

The port's own copy of ``masklab_tpu/data/generator.py``, host numpy / cv2
only (it never touches the device; the trainer uploads):
  * accepts a dataset *config dict* so worker processes can rebuild the
    dataset;
  * multi-scale resize from a static bucket list (compute.scale_buckets),
    each scale floored to a multiple of 32;
  * gt boxes are rescaled for non-padding rows; instance masks
    nearest-resized per slot;
  * ``MultiprocessLoader`` builds batches in spawned worker processes,
    ``PrefetchIterator`` in a background thread, overlapping host work with
    the device;
  * ``shard=(rank, world)``: a rank of a data-parallel trainer builds only
    its rows of each global batch; every rank keeps the same shuffle and
    the same scale draws.

Spans (``utils.profiling``): a batch is ``data:read`` (the dataset's
slice: its decodes and re-rasterization) then ``data:rescale``; in the
prefetch thread each batch is a ``data:batch`` span with the batch's
index ``k`` (unique in the process), around its building and
``data:queue_put`` (blocked on a full queue: the producer is ahead). The
counter ``data.queue_empty`` counts each batch the consumer asked for
while the queue was empty.
"""
from __future__ import annotations

import itertools
import queue
import threading
from typing import (Dict, Iterable, Iterator, Optional, Sequence, Tuple,
                    Union)

import cv2
import numpy as np

from ..utils.profiling import count, span
from .dataset import MaskLabDataset

# the prefetched batches' indices, over every prefetcher of the process
_batch_ids = itertools.count()


class MaskLabGenerator:
    def __init__(self, dataset: Union[MaskLabDataset, Dict],
                 scale_ratio=(0.4, 0.6), batch_size: int = 8,
                 shuffle: bool = True,
                 scale_buckets: Sequence[float] = (0.4, 0.45, 0.5, 0.55, 0.6),
                 seed: int = 0, shard: Optional[Tuple[int, int]] = None):
        if isinstance(dataset, dict):
            self.dataset = MaskLabDataset(**dataset)
        elif isinstance(dataset, MaskLabDataset):
            self.dataset = dataset
        else:
            raise ValueError('dataset must be a dict or MaskLabDataset')
        self.scale_ratio = scale_ratio
        lo, hi = (scale_ratio if isinstance(scale_ratio, (tuple, list))
                  else (scale_ratio, scale_ratio))
        self.scale_buckets = [s for s in scale_buckets if lo <= s <= hi] \
            or [lo]
        self.batch_size = batch_size
        if shard is not None and batch_size % shard[1]:
            raise ValueError(f'a batch of {batch_size} does not divide over '
                             f'{shard[1]} ranks')
        self.shard = shard
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.on_epoch_end()

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def __getitem__(self, index: int) -> Dict:
        """Batch ``index``, or this rank's rows of it (``shard``)."""
        start, rows = self.batch_size * index, self.batch_size
        if self.shard is not None:
            rows //= self.shard[1]
            start += self.shard[0] * rows
        with span('data:read'):
            data = self.dataset[start:start + rows]
        scale = self.scale_buckets[
            self.rng.randint(len(self.scale_buckets))]
        with span('data:rescale'):
            return self.rescale_batch(data, scale)

    @staticmethod
    def rescale_batch(data: Dict, scale_ratio: float) -> Dict:
        images = data['images']
        gt_seg = data['semantic'].astype(np.float64)
        gt_boxes = data['detection'].copy()
        gt_masks = data['instance']

        height, width = images.shape[1:3]
        th = (int(height * scale_ratio) // 32) * 32
        tw = (int(width * scale_ratio) // 32) * 32

        batch_images = np.stack([cv2.resize(im, (tw, th)) for im in images])
        batch_seg = np.round(np.stack(
            [cv2.resize(seg, (tw, th)).reshape(th, tw, -1)
             for seg in gt_seg]))

        b, max_instances = gt_masks.shape[:2]
        batch_masks = np.full((b, max_instances, th, tw), -1, np.int8)
        for i in range(b):
            for j in range(max_instances):
                if gt_masks[i, j, 0, 0] == -1:
                    continue
                batch_masks[i, j] = cv2.resize(
                    gt_masks[i, j].astype(np.uint8), (tw, th))

        not_ignore = gt_boxes[..., 5] > 0
        gt_boxes[not_ignore, 0] *= tw / width
        gt_boxes[not_ignore, 1] *= th / height
        gt_boxes[not_ignore, 2] *= tw / width
        gt_boxes[not_ignore, 3] *= th / height

        return {'images': batch_images.astype(np.float32),
                'gt_seg': batch_seg.astype(np.float32),
                'gt_seg_exist': data['semantic_exist'].astype(np.float32),
                'gt_boxes': gt_boxes.astype(np.float32),
                'gt_boxes_exist': data['instance_exist'].astype(np.float32),
                'gt_masks': batch_masks.astype(np.float32)}

    def on_epoch_end(self) -> None:
        if self.shuffle:
            self.dataset.shuffle(self.rng)

    def __iter__(self) -> Iterator[Dict]:
        for i in range(len(self)):
            yield self[i]
        self.on_epoch_end()


def pad_boxes_to(batch: Dict, max_boxes: int) -> Dict:
    """Pad/trim gt_boxes+gt_masks to a static slot count (every step the
    same shapes; the original padded to the per-batch max)."""
    out = dict(batch)
    boxes = batch['gt_boxes']
    masks = batch['gt_masks']
    b, g = boxes.shape[:2]
    if g >= max_boxes:
        out['gt_boxes'] = boxes[:, :max_boxes]
        out['gt_masks'] = masks[:, :max_boxes]
    else:
        pad_b = np.full((b, max_boxes - g, 6), -1.0, boxes.dtype)
        out['gt_boxes'] = np.concatenate([boxes, pad_b], axis=1)
        pad_m = np.full((b, max_boxes - g) + masks.shape[2:], -1.0,
                        masks.dtype)
        out['gt_masks'] = np.concatenate([masks, pad_m], axis=1)
    return out


class MultiprocessLoader:
    """Worker-process batch loading (the fit_generator worker-pool
    equivalent, engine/train.py:106-109).

    Workers rebuild the dataset from its config dict — the reference's
    multiprocessing-safety trick (generator/masklab.py:19-26) — and produce
    batches by index; the parent interleaves requests round-robin.
    ``shard``: as ``MaskLabGenerator``'s, each worker builds the rank's rows.
    """

    def __init__(self, dataset_config: Dict, num_workers: int = 4,
                 batch_size: int = 8, scale_ratio=(0.4, 0.6),
                 scale_buckets=(0.4, 0.45, 0.5, 0.55, 0.6),
                 prefetch: int = 4, shuffle: bool = True, seed: int = 0,
                 shard: Optional[Tuple[int, int]] = None):
        import multiprocessing as mp
        # spawn, not fork: the parent holds CUDA and thread pools, which a
        # forked child would inherit mid-flight; spawned workers rebuild the
        # generator from the picklable config instead, and never touch CUDA
        self._ctx = mp.get_context('spawn')
        self.generator_args = dict(
            dataset=dataset_config, batch_size=batch_size,
            scale_ratio=scale_ratio, scale_buckets=scale_buckets,
            shuffle=False, shard=shard)
        probe = MaskLabGenerator(**self.generator_args)
        self.num_batches = len(probe)
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        self._pool = None

    def _ensure_pool(self):
        if self._pool is None:
            self._pool = self._ctx.Pool(
                self.num_workers, initializer=_loader_init,
                initargs=(self.generator_args,))
        return self._pool

    def __len__(self):
        return self.num_batches

    def __iter__(self):
        pool = self._ensure_pool()
        # per-epoch reshuffle: every worker re-sorts its dataset copy from
        # the canonical case order with the SAME epoch-derived seed, so
        # batch `i` is identical regardless of which worker builds it —
        # while batch order still varies epoch to epoch (the in-process
        # generator reshuffles per epoch; workers must match)
        # the seed mixes MULTIPLICATIVELY with the epoch: an additive
        # seed+epoch would make (seed=0, epoch=1) and (seed=1, epoch=0)
        # replay identical shuffles and scale streams, defeating seed
        # isolation between differently-seeded runs
        mixed = (self.seed * 1_000_003 + self._epoch) % (2 ** 31)
        epoch_seed = mixed if self.shuffle else None
        # the scale-bucket rng seed advances with the epoch regardless of
        # the shuffle flag, as the in-process generator's rng does
        scale_base = mixed + 1
        self._epoch += 1
        for batch in pool.imap(_loader_get,
                               [(epoch_seed, scale_base, i)
                                for i in range(self.num_batches)],
                               chunksize=1):
            yield batch

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool = None


_WORKER_GENERATOR = None
_WORKER_CANONICAL = None
_WORKER_EPOCH_SEED = -1


def _loader_init(generator_args):
    global _WORKER_GENERATOR, _WORKER_CANONICAL, _WORKER_EPOCH_SEED
    _WORKER_GENERATOR = MaskLabGenerator(**generator_args)
    _WORKER_CANONICAL = np.array(_WORKER_GENERATOR.dataset.cases)
    _WORKER_EPOCH_SEED = -1


def _loader_get(args):
    epoch_seed, scale_base, index = args
    global _WORKER_EPOCH_SEED
    gen = _WORKER_GENERATOR
    if epoch_seed != _WORKER_EPOCH_SEED:
        # deterministic shuffle from the canonical order (NOT cumulative:
        # workers may skip epochs, so each epoch's order must be a pure
        # function of its seed). epoch_seed is None <=> shuffle disabled.
        gen.dataset.cases = _WORKER_CANONICAL.copy()
        if epoch_seed is not None:
            gen.dataset.shuffle(np.random.RandomState(epoch_seed))
        _WORKER_EPOCH_SEED = epoch_seed
    # scale bucket choice deterministic per (seed, epoch, index) so the
    # batch is reproducible no matter which worker serves it — and varies
    # across epochs even with shuffle=False
    gen.rng = np.random.RandomState(
        (scale_base * 100003 + index) % (2 ** 31))
    return gen[index]


class PrefetchIterator:
    """Background-thread prefetch wrapping any batch iterable.

    ``close()`` stops the fill thread promptly: an abandoned
    PrefetchIterator otherwise blocks forever on ``q.put`` holding
    ``prefetch`` full batches alive, keeps consuming the underlying
    iterator, and (for MaskLabGenerator) can fire its end-of-epoch shuffle
    concurrently with a successor's ``__getitem__``.

    ``k``: the index of the batch the iterator gave last."""

    def __init__(self, iterable: Iterable, prefetch: int = 4):
        self.iterable = iterable
        self.q: queue.Queue = queue.Queue(maxsize=prefetch)
        self.k: Optional[int] = None
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._fill, daemon=True)
        self.thread.start()

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _fill(self):
        items = iter(self.iterable)
        try:
            # once stopped, do NOT advance the source iterator further
            while not self._stop.is_set():
                with span('data:batch') as built:
                    item = next(items, None)
                    if item is None:
                        return
                    k = next(_batch_ids)
                    built.set(k=k)
                    with span('data:queue_put'):
                        self._put((k, item))
        finally:
            self._put(None)

    def close(self, timeout: float = 5.0):
        """Stop the fill thread without consuming the source further."""
        self._stop.set()
        self.thread.join(timeout=timeout)

    def __iter__(self):
        while True:
            if self.q.empty():
                count('data.queue_empty')
            item = self.q.get()
            if item is None:
                return
            self.k, batch = item
            yield batch
