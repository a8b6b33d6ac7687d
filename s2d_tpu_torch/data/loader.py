"""The loaders and pipeline threads of `s2d_tpu/data/loader.py`.

  * `collate_clips` and `train_loader`: an infinite shuffled sampler over
    the dataset records, the clip mapper, a batch transform (copy-paste),
    and fixed-shape collation (the frames normalized and zero-padded to a
    per-batch canvas bucketed to 64 pixels), on a background thread. A
    process takes every num_shards-th record of the seeded permutation
    from shard_index. Batches leave as numpy arrays; the train loop uploads
    them. The target masks leave bit-packed along W by default
    (`pack_masks`, numpy's MSB-first `packbits`): they are the largest
    array a step uploads, and the step unpacks them on the device. A
    batch of disentangled samples also carries the distillation view
    ("distill_images", "distill_affine").
  * `FinalizeThread` and `Prefetcher`, the pipeline threads of both
    loops, with their deadlock-safe error paths.
"""
from __future__ import annotations

import itertools
import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np


def _bucket(value: int, multiple: int = 64) -> int:
    return -(-value // multiple) * multiple


def collate_clips(
    samples: List[dict],
    pixel_mean: Sequence[float],
    pixel_std: Sequence[float],
    size_divisibility: int = 32,
    bucket_multiple: int = 64,
    pack_masks: bool = False,
) -> Dict[str, np.ndarray]:
    """Normalize, pad to the batch's bucketed canvas, stack: {"images"
    (B, T, H, W, 3) float32, "masks" (B, N, T, H, W) bool, or with
    `pack_masks` (B, N, T, H, W / 8) uint8 (the canvas W is a multiple of
    8), "valid" (B, N)}; with a distillation view in the samples also
    "distill_images" (B, T, H, W, 3) and "distill_affine" (B, T, 3, 3) on
    a canvas that holds both views."""
    t = samples[0]["image"].shape[0]
    max_h = _bucket(_bucket(max(s["image"].shape[1] for s in samples), bucket_multiple),
                    size_divisibility)
    max_w = _bucket(_bucket(max(s["image"].shape[2] for s in samples), bucket_multiple),
                    size_divisibility)
    has_distill = "distill_image" in samples[0]
    if has_distill:  # the canvas holds both views, decided before allocating
        max_h = max(max_h, _bucket(max(s["distill_image"].shape[1] for s in samples),
                                   bucket_multiple))
        max_w = max(max_w, _bucket(max(s["distill_image"].shape[2] for s in samples),
                                   bucket_multiple))
    mean = np.asarray(pixel_mean, np.float32)
    std = np.asarray(pixel_std, np.float32)
    b = len(samples)
    n = samples[0]["masks"].shape[0]
    images = np.zeros((b, t, max_h, max_w, 3), np.float32)
    masks = np.zeros((b, n, t, max_h, max_w), bool)
    valid = np.zeros((b, n), bool)
    if has_distill:
        distill = np.zeros((b, t, max_h, max_w, 3), np.float32)
        affine = np.zeros((b, t, 3, 3), np.float32)
    for i, s in enumerate(samples):
        _, h, w, _ = s["image"].shape
        images[i, :, :h, :w] = (s["image"] - mean) / std
        masks[i, :, :, :h, :w] = s["masks"]
        valid[i] = s["valid"]
        if has_distill:
            _, dh, dw, _ = s["distill_image"].shape
            distill[i, :, :dh, :dw] = (s["distill_image"] - mean) / std
            affine[i] = s["distill_affine"]
    if pack_masks:
        masks = np.packbits(masks, axis=-1)
    batch = {"images": images, "masks": masks, "valid": valid}
    if has_distill:
        batch["distill_images"] = distill
        batch["distill_affine"] = affine
    return batch


def train_loader(
    dataset_dicts: List[dict],
    mapper: Callable[[dict], dict],
    batch_size: int,
    pixel_mean: Sequence[float],
    pixel_std: Sequence[float],
    seed: int = 0,
    num_shards: int = 1,
    shard_index: int = 0,
    prefetch: int = 2,
    batch_transform: Optional[Callable[[List[dict]], List[dict]]] = None,
    pack_masks: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite `Prefetcher` of collated batches of this process's shard,
    mapped `prefetch` batches ahead on a background thread (close it when
    done). `batch_transform` (the copy-paste) runs on the uncollated
    samples, on that thread. The targets leave bit-packed unless
    `pack_masks=False`."""
    rng = np.random.RandomState(seed)

    def sample_stream():
        while True:
            order = rng.permutation(len(dataset_dicts))[shard_index::num_shards]
            for idx in order:
                s = mapper(dataset_dicts[idx])
                if s is not None:
                    yield s

    def batch_stream():
        stream = sample_stream()
        while True:
            samples = list(itertools.islice(stream, batch_size))
            if batch_transform is not None:
                samples = batch_transform(samples)
            yield collate_clips(samples, pixel_mean, pixel_std, pack_masks=pack_masks)

    return Prefetcher(batch_stream(), prefetch)


class FinalizeThread:
    """Bounded background consumer for device->host finalize work (the
    readback + encode half of the prefetch/compute/finalize overlap the
    evaluator runs).

    Deadlock-safe error path: after the callback raises, the worker keeps
    DRAINING the queue (discarding items) until close(), so a producer
    blocked in put() always wakes; put() re-raises the worker's error
    early, and close() flushes, joins, and re-raises it."""

    _SENTINEL = object()

    def __init__(self, fn, depth: int = 2):
        self._fn = fn
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: list = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is self._SENTINEL:
                return
            if self._err:
                continue  # failed already: just drain
            try:
                self._fn(*item)
            except BaseException as e:  # re-raised by put() and close()
                self._err.append(e)

    def put(self, *item) -> None:
        if self._err:
            raise self._err[0]
        self._q.put(item)

    def close(self) -> None:
        """Flush remaining work, join, and re-raise any worker error."""
        self._q.put(self._SENTINEL)
        self._thread.join()
        if self._err:
            raise self._err[0]


class Prefetcher:
    """Runs the iterator `it` on a daemon thread, `depth` items ahead of the
    consumer. An error in `it` is re-raised by `next` (a swallowed error
    would silently truncate the dataset); `close()` stops the thread, after
    the item it is producing."""

    _DONE = object()

    def __init__(self, it: Iterator, depth: int):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: list = []
        self._thread = threading.Thread(target=self._run, args=(it,), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, it: Iterator) -> None:
        try:
            for item in it:
                if not self._put(item):
                    return
        except BaseException as e:  # re-raised on the consumer side
            self._err.append(e)
        self._put(self._DONE)

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            self._q.put(item)  # a later next() ends too
            if self._err:
                raise self._err[0]
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        self._thread.join()
