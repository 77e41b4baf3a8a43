"""imSitu dataset and its prefetching host loader.

Port of ``situation_recognition_tpu/data/dataset.py``:

* annotations are encoded once at construction into dense arrays (verbs
  (N,), labels (N, 3, R));
* images come from PIL per image (``decoder='python'``), the native libjpeg
  batch decoder (``'native'``; ``'auto'`` picks it when it builds), a
  decoded cache in host memory, a packed store (``enable_packed``:
  ``images.bin`` + ``index.json``), or a window cache that the trainer
  keeps on the device (``enable_window_cache``, with a partial prefix);
* worker threads fill each batch and a producer thread keeps a bounded
  queue of ready batches;
* crops and flips come from ``np.random.Generator``s seeded with (seed,
  epoch, index), so a batch does not depend on the worker count, and the
  port's batches equal the JAX loader's bit for bit.

A batch is a dict: ``names`` list[str], ``images`` (B, S, S, 3) uint8 (or,
from a window cache, ``indices`` (B,) int32 rows into it), ``verbs`` (B,)
int32, ``labels`` (B, 3, R) int32, ``flip`` (B,) bool.  The last partial
batch is yielded at its true size; the trainer wraps it.

``shard=(rank, world)`` (multi-process data parallelism, JAX ``shard=``):
the loader makes only block ``rank`` of ``batch_size / world`` rows of
every global batch.  The epoch order, the wrap of the last partial batch
and the crop and flip draws are taken at the global level first, so the
blocks of every rank together are the unsharded loader's batch, wrapped as
the trainer wraps it, bit for bit.  A sharded batch also carries
``global_n`` (the real rows of the global batch), ``shard``, and the whole
batch's ``verbs_global`` / ``labels_global`` for scoring.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from situation_recognition_tpu_torch.data.encoder import ImsituEncoder
from situation_recognition_tpu_torch.data.transforms import (
    CROP, WINDOW, host_window, host_window_exact, normalize_short_side)


def _decode_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def put_until_stopped(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Put ``item`` into the bounded ``q``, waiting for a free slot until
    ``stop`` is set; → whether it went in.  A producer's error goes
    through here too, so it reaches the consumer however full the queue
    is, and a producer whose consumer has gone never blocks for good."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return True
        except queue.Full:
            continue
    return False


def write_packed(packed_dir: str, images) -> int:
    """Write a packed store (``ImsituDataset.enable_packed``) from (name,
    HWC uint8 image) pairs, each normalised to short side 256 as the live
    loader does (the JAX package's ``tools/pack_dataset.py`` layout);
    → the count written."""
    os.makedirs(packed_dir, exist_ok=True)
    index, offset = {}, 0
    tmp = os.path.join(packed_dir, f"images.bin.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        for name, img in images:
            img = np.ascontiguousarray(normalize_short_side(
                np.asarray(img, dtype=np.uint8)))
            f.write(img.tobytes())
            index[name] = [offset, int(img.shape[0]), int(img.shape[1])]
            offset += img.nbytes
    os.replace(tmp, os.path.join(packed_dir, "images.bin"))
    with open(os.path.join(packed_dir, "index.json"), "w") as f:
        json.dump(index, f)
    return len(index)


class ImsituDataset:
    """Decoded-on-demand imSitu split with pre-encoded annotations."""

    def __init__(self, img_dir: str, annotations: Dict[str, dict],
                 encoder: ImsituEncoder, train: bool,
                 preproc: str = "window"):
        """``preproc``: 'window' (256² host window + device resize) or
        'exact' (eval only: the reference's host ``Resize(224)`` +
        ``CenterCrop(224)``, the device resize then the identity)."""
        if preproc not in ("window", "exact"):
            raise ValueError(f"unknown preproc {preproc!r}")
        if preproc == "exact" and train:
            raise ValueError(
                "preproc='exact' is an eval/inference parity mode; the "
                "train path keeps the window pipeline")
        self.img_dir = img_dir
        self.encoder = encoder
        self.train = train
        self.preproc = preproc
        #: side of the host windows a batch holds
        self.window_size = CROP if preproc == "exact" else WINDOW
        self.names: List[str] = list(annotations.keys())
        n = len(self.names)
        self.verbs = np.zeros((n,), dtype=np.int32)
        self.labels = np.zeros((n, ImsituEncoder.NUM_FRAMES,
                                encoder.max_role_count), dtype=np.int32)
        for i, name in enumerate(self.names):
            v, l = encoder.encode(annotations[name])
            if l.shape[0] != ImsituEncoder.NUM_FRAMES:
                raise ValueError(
                    f"{name!r} has {l.shape[0]} annotation frames, "
                    f"expected {ImsituEncoder.NUM_FRAMES}")
            self.verbs[i] = v
            self.labels[i] = l
        self._decoded_cache: Optional[dict] = None
        self._packed = None
        self._window_cache = None
        self.window_cache_rows = 0

    def __len__(self) -> int:
        return len(self.names)

    def enable_decode_cache(self) -> None:
        """Keep decoded uint8 images in host memory."""
        self._decoded_cache = {}

    def enable_packed(self, packed_dir: str) -> None:
        """Serve images from a packed store (``images.bin``, flat uint8,
        read as a memmap, + ``index.json`` {name: [offset, h, w]}) whose
        images are already short-side-normalised."""
        if self.preproc == "exact":
            # the pack is resized to short side 256; the exact path would
            # resample it a second time
            raise ValueError(
                "preproc='exact' cannot run from a packed store (already "
                "short-side-normalised; a second resample breaks "
                "reference-exact parity) — use the image files")
        with open(os.path.join(packed_dir, "index.json")) as f:
            self._packed_index = json.load(f)
        missing = [n for n in self.names if n not in self._packed_index]
        if missing:
            raise ValueError(
                f"packed store {packed_dir} misses {len(missing)} images "
                f"(first: {missing[:3]})")
        self._packed = np.memmap(os.path.join(packed_dir, "images.bin"),
                                 dtype=np.uint8, mode="r")
        end = max((off + h * w * 3
                   for off, h, w in self._packed_index.values()), default=0)
        if end > self._packed.size:
            raise ValueError(
                f"packed store {packed_dir} is truncated or stale: the "
                f"index needs {end} bytes, images.bin has "
                f"{self._packed.size}")

    @property
    def packed(self) -> bool:
        return self._packed is not None

    def enable_window_cache(self, max_rows: Optional[int] = None) -> None:
        """Compute every host window once, for the trainer to keep on the
        device (``--cache_device``): a batch is then a gather of row
        ``indices`` on the device, and no pixels move per step.

        The windows must be deterministic: eval windows are; a train split
        is accepted only when every image is exactly WINDOW² after the
        short-side resize (its random crop has one offset).  The flip stays
        live, from the same per-(seed, epoch, index) draws.  ``max_rows``
        caches the prefix [0, max_rows) only (an unshuffled eval split
        then streams the rest)."""
        if self._decoded_cache is not None:
            raise ValueError("enable_window_cache and enable_decode_cache "
                             "are alternatives; pick one")
        rows = len(self.names) if max_rows is None \
            else max(0, min(int(max_rows), len(self.names)))
        S = self.window_size
        cache = np.empty((rows, S, S, 3), dtype=np.uint8)
        for i in range(rows):
            if self.train:
                img = normalize_short_side(self.load_image(i))
                if img.shape[:2] != (S, S):
                    raise ValueError(
                        f"a device window cache of a TRAIN split needs "
                        f"square {S}x{S} sources (one crop offset); "
                        f"{self.names[i]!r} is {img.shape[:2]} — use "
                        f"--cache_decoded / --packed_dir instead")
                cache[i] = img
            else:
                cache[i] = self.load_window(i, None)
        self._window_cache = cache
        #: rows [0, window_cache_rows) are served as device gathers
        self.window_cache_rows = rows

    @property
    def window_cached(self) -> bool:
        return self._window_cache is not None

    @property
    def window_cache(self) -> Optional[np.ndarray]:
        return self._window_cache

    def load_image(self, idx: int) -> np.ndarray:
        if self.packed:
            off, h, w = self._packed_index[self.names[idx]]
            return self._packed[off:off + h * w * 3].reshape(h, w, 3)
        if self._decoded_cache is not None and idx in self._decoded_cache:
            return self._decoded_cache[idx]
        img = _decode_image(os.path.join(self.img_dir, self.names[idx]))
        if self._decoded_cache is not None:
            self._decoded_cache[idx] = img
        return img

    def load_window(self, idx: int,
                    rng: Optional[np.random.Generator]) -> np.ndarray:
        if self.preproc == "exact":
            return host_window_exact(self.load_image(idx))
        return host_window(self.load_image(idx), self.train, rng)


class ImsituLoader:
    """Seeded, thread-prefetched batch iterator over an ``ImsituDataset``."""

    def __init__(self, dataset: ImsituDataset, batch_size: int,
                 shuffle: bool, seed: int = 0, num_workers: int = 2,
                 prefetch: int = 2, drop_last: bool = False,
                 decoder: str = "auto", shard=None):
        """``decoder``: 'native' (libjpeg batch decode), 'python' (PIL per
        image) or 'auto' (native when it builds, else python).  The two
        draw their crops and flips from different streams.  ``shard``:
        ``(rank, world)``, this rank's block of every global batch (see
        the module docstring)."""
        if shard is not None:
            rank, world = shard
            if world < 1 or not 0 <= rank < world:
                raise ValueError(f"bad shard {shard}: need 0 <= rank < "
                                 f"world")
            if batch_size % world != 0:
                raise ValueError(f"global batch {batch_size} not divisible "
                                 f"by world size {world}")
        self.shard = shard
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        if prefetch < 1:
            # Queue(maxsize=0) is unbounded: the whole epoch in host memory
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.epoch = 0
        if dataset.packed or dataset.window_cached:
            decoder = "python"      # memmap slices / index-only batches
        elif dataset.preproc == "exact":
            decoder = "python"      # the C decoder emits 256² windows only
        elif decoder == "auto":
            from situation_recognition_tpu_torch.data import native_decoder

            decoder = "native" if native_decoder.available() else "python"
        self.decoder = decoder
        #: one-shot batch offset for a mid-epoch resume (reset by __iter__)
        self.start_batch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        return order

    def _rng(self, idx: int) -> Optional[np.random.Generator]:
        if not self.dataset.train:
            return None
        return np.random.default_rng((self.seed, self.epoch, int(idx)))

    def _make_batch(self, indices: np.ndarray) -> Dict:
        ds = self.dataset
        B = len(indices)
        if ds.window_cached:
            if int(np.max(indices)) < ds.window_cache_rows:
                return self._make_batch_indices(indices)
            # a partial prefix, and this batch reaches past it: pixels
        # checked per batch: enable_packed may come after the loader, and
        # the packed store must then win over the native decoder
        if (self.decoder == "native" and ds._decoded_cache is None
                and not ds.packed):
            return self._make_batch_native(indices)
        S = ds.window_size
        images = np.empty((B, S, S, 3), dtype=np.uint8)
        flip = np.zeros((B,), dtype=bool)
        errors: List[BaseException] = []

        def fill(pairs):
            # one generator per (seed, epoch, example): the crop, then the
            # flip
            try:
                for slot, idx in pairs:
                    rng = self._rng(idx)
                    images[slot] = ds.load_window(int(idx), rng)
                    if rng is not None:
                        flip[slot] = rng.random() < 0.5
            except BaseException as e:
                errors.append(e)

        pairs = list(enumerate(indices))
        cache = ds._decoded_cache
        # memmap slices and cache hits are GIL-bound numpy work: threads
        # only contend there, so they fill on one thread
        no_decode = ds.packed or (
            cache is not None and all(int(i) in cache for i in indices))
        if self.num_workers > 1 and B > 1 and not no_decode:
            chunks = np.array_split(np.arange(B), self.num_workers)
            threads = [threading.Thread(target=fill,
                                        args=([pairs[i] for i in c],))
                       for c in chunks if len(c)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        else:
            fill(pairs)
        if errors:
            raise errors[0]
        return {"names": [ds.names[int(i)] for i in indices],
                "images": images,
                "verbs": ds.verbs[indices],
                "labels": ds.labels[indices],
                "flip": flip}

    def _make(self, gidx: np.ndarray) -> Dict:
        """The batch of global indices ``gidx``, or with ``shard`` this
        rank's block of it: the partial last batch wrapped at the index
        level (``arange(B) % n``, the trainer's wrap), then the block."""
        if self.shard is None:
            return self._make_batch(gidx)
        rank, world = self.shard
        n = len(gidx)
        if n < self.batch_size:
            gidx = gidx[np.arange(self.batch_size) % n]
        per = self.batch_size // world
        b = self._make_batch(gidx[rank * per:(rank + 1) * per])
        b["global_n"] = n
        b["shard"] = self.shard
        # scoring reads every row's annotations; only pixels are sharded
        b["verbs_global"] = self.dataset.verbs[gidx]
        b["labels_global"] = self.dataset.labels[gidx]
        return b

    def _make_batch_indices(self, indices: np.ndarray) -> Dict:
        """A batch of a window-cached split: row ``indices``, no pixels.
        The flips replay the python path's per-example stream: the
        (square) crop draws ``integers(0, 1)`` twice before the flip."""
        ds = self.dataset
        flip = np.zeros((len(indices),), dtype=bool)
        if ds.train:
            for slot, idx in enumerate(indices):
                rng = self._rng(idx)
                rng.integers(0, 1)
                rng.integers(0, 1)
                flip[slot] = rng.random() < 0.5
        return {"names": [ds.names[int(i)] for i in indices],
                "indices": np.asarray(indices, dtype=np.int32),
                "verbs": ds.verbs[indices],
                "labels": ds.labels[indices],
                "flip": flip}

    def _make_batch_native(self, indices: np.ndarray) -> Dict:
        """One C call decodes the batch; PIL for each image it fails on."""
        from situation_recognition_tpu_torch.data import native_decoder

        ds = self.dataset
        paths = [os.path.join(ds.img_dir, ds.names[int(i)]) for i in indices]
        images, flips, failed = native_decoder.decode_window_batch(
            paths, ds.train, self.seed, self.epoch,
            [int(i) for i in indices], num_threads=self.num_workers)
        if not ds.train:
            flips = np.zeros((len(indices),), dtype=bool)
        for slot in np.nonzero(failed)[0]:
            idx = int(indices[slot])
            rng = self._rng(idx)
            images[slot] = ds.load_window(idx, rng)
            if rng is not None:
                flips[slot] = rng.random() < 0.5
        return {"names": [ds.names[int(i)] for i in indices],
                "images": images,
                "verbs": ds.verbs[indices],
                "labels": ds.labels[indices],
                "flip": flips}

    def __iter__(self) -> Iterator[Dict]:
        order = self._epoch_order()
        n = len(order)
        stop_at = n - (n % self.batch_size if self.drop_last else 0)
        index_batches = [order[s:s + self.batch_size]
                         for s in range(0, stop_at, self.batch_size)]
        if self.start_batch:
            index_batches = index_batches[self.start_batch:]
            self.start_batch = 0
        if self.shard is not None and self.dataset.window_cached:
            raise ValueError(
                "sharded loading does not compose with the device window "
                "cache (one process's device-resident batches); disable "
                "one")

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        end = object()

        def producer():
            try:
                for idxs in index_batches:
                    if not put_until_stopped(q, self._make(idxs), stop):
                        return
                put_until_stopped(q, end, stop)
            except BaseException as e:    # raised again by the consumer
                put_until_stopped(q, e, stop)

        t = threading.Thread(target=producer, name="srtorch-loader",
                             daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is end:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            t.join()
