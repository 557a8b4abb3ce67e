"""The MultibatchData pipeline: sample -> decode (host threads) -> upload
-> augment (device) — port of ``npairloss_tpu/data/loader.py``.

The host samples identity-balanced index batches, decodes and resizes
the images, and keeps a bounded queue of ready uint8 batches (in pinned
memory when the device is a card).  ``__next__`` copies a batch to the
device asynchronously, converts it to fp32 there (uint8 -> fp32 is
exact) and runs the augmentation on the device (``data.transforms``),
with a ``torch.Generator`` on the device seeded from ``seed``.  It
returns (images fp32 [B, H, W, 3], labels int32 [B]), both on the
device.

The ``data.worker`` failpoint crashes the prefetch worker where the JAX
loader's does (``_produce_one``), exercising the bounded respawn.

Over a mesh every rank builds the same loader (same list file, same
seed) and :func:`shard_batches` keeps its rows of each global batch.
The augmentation draws for the whole global batch come first, from the
one device generator, so a rank's crops are the ones the single-process
run gives those rows.
"""

from __future__ import annotations

import logging
import queue
import threading
import weakref
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from npairloss_tpu_torch.config.schema import DataLayerConfig, TransformerConfig
from npairloss_tpu_torch.data.dataset import ListFileDataset
from npairloss_tpu_torch.data.sampler import IdentityBalancedSampler
from npairloss_tpu_torch.data.transforms import augment
from npairloss_tpu_torch.device import DeviceLike, resolve_device
from npairloss_tpu_torch.resilience import failpoints

log = logging.getLogger("npairloss_tpu_torch.data")


class PrefetchWorkerError(RuntimeError):
    """The prefetch worker died more times in a row than the respawn
    budget allows; ``batch_index`` is the batch it died on."""

    def __init__(self, msg: str, batch_index: int, respawns: int):
        super().__init__(msg)
        self.batch_index = batch_index
        self.respawns = respawns


class _WorkerFailure:
    """Queue marker for a worker death: the exception and the batch index
    it died on."""

    __slots__ = ("exc", "batch_index")

    def __init__(self, exc: BaseException, batch_index: int):
        self.exc = exc
        self.batch_index = batch_index


def _identity_counts(cfg: DataLayerConfig) -> Tuple[int, int]:
    ids = cfg.identity_num_per_batch
    imgs = cfg.img_num_per_identity
    if not ids or not imgs:
        # Pairs: the least the mining contract allows.
        imgs = imgs or 2
        ids = ids or max(1, (cfg.batch_size or 2) // imgs)
    return ids, imgs


class _DeviceSide:
    """What both loaders share: the device, the augmentation generator,
    and the step from a host batch to an augmented device batch."""

    def _init_device(self, cfg, transformer, train, seed, device):
        self.cfg = cfg
        self.transformer = transformer
        self.train = train
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def _to_device(self, images: torch.Tensor, labels: torch.Tensor):
        x = images.to(self.device, non_blocking=True).to(torch.float32)
        lab = labels.to(self.device, non_blocking=True)
        return _maybe_augment(self, x), lab


class MultibatchLoader(_DeviceSide):
    """Iterator of (images fp32 NHWC, labels int32) device batches from a
    dataset with ``labels`` and ``load_batch``; a prefetch thread samples
    and decodes ``prefetch`` batches ahead."""

    def __init__(self, dataset, cfg: DataLayerConfig,
                 transformer: Optional[TransformerConfig] = None,
                 train: bool = True, seed: int = 0, prefetch: int = 2,
                 max_worker_restarts: int = 3, device: DeviceLike = None):
        self._init_device(cfg, transformer, train, seed, device)
        self.dataset = dataset
        ids, imgs = _identity_counts(cfg)
        self.sampler = IdentityBalancedSampler(
            dataset.labels, ids, imgs, rand_identity=cfg.rand_identity,
            shuffle=cfg.shuffle, seed=seed)
        self._pin = self.device.type == "cuda"
        self._queue: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        # A worker death respawns the thread up to max_worker_restarts
        # times in a row; a delivered batch resets the budget, so sparse
        # transient errors never add up to an abort while a deterministic
        # failure still surfaces after max_worker_restarts + 1 attempts.
        self.max_worker_restarts = max_worker_restarts
        self._respawns = 0
        self._batch_seq = 0  # written by the (single) worker thread only
        self._spawn_worker()

    def _spawn_worker(self):
        # The worker holds only a weakref to the loader, so an abandoned
        # loader is still collectable; __del__ then stops the thread.
        self._thread = threading.Thread(
            target=_prefetch_worker,
            args=(weakref.ref(self), self._queue, self._stop), daemon=True)
        self._thread.start()

    def _produce_one(self):
        """Host side, on the worker thread: sample, decode, pin."""
        failpoints.fire("data.worker")
        idx = next(self.sampler)
        images = torch.from_numpy(
            np.ascontiguousarray(self.dataset.load_batch(idx)))
        labels = torch.from_numpy(self.dataset.labels[idx].astype(np.int32))
        if self._pin:
            images, labels = images.pin_memory(), labels.pin_memory()
        self._batch_seq += 1
        return images, labels

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._stop.is_set():
                raise StopIteration("loader is closed")
            item = self._queue.get()
            if isinstance(item, _WorkerFailure):
                if self._respawns < self.max_worker_restarts:
                    self._respawns += 1
                    log.warning(
                        "data prefetch worker died at batch %d (%s: %s); "
                        "respawning (%d/%d)", item.batch_index,
                        type(item.exc).__name__, item.exc, self._respawns,
                        self.max_worker_restarts)
                    self._spawn_worker()
                    continue
                self._stop.set()
                raise PrefetchWorkerError(
                    f"data prefetch worker failed at batch "
                    f"{item.batch_index} after {self._respawns} respawns: "
                    f"{type(item.exc).__name__}: {item.exc}",
                    item.batch_index, self._respawns) from item.exc
            self._respawns = 0  # a healthy batch: the budget is per streak
            return self._to_device(*item)

    def close(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self._stop.set()
        except AttributeError:  # __init__ failed before the event existed
            pass


def _prefetch_worker(loader_ref, q: queue.Queue, stop: threading.Event):
    """Holds only a weakref to the loader (and its queue and stop event,
    which do not point back), so an abandoned loader is collectable even
    while the worker blocks on a full queue."""

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=1.0)
                return True
            except queue.Full:
                continue
        return False

    while not stop.is_set():
        loader = loader_ref()
        if loader is None:
            return
        try:
            item = loader._produce_one()
            fatal = False
        except BaseException as exc:  # surfaced by __next__, with context
            item, fatal = _WorkerFailure(exc, loader._batch_seq), True
        del loader  # no strong reference while blocking on the queue
        if not put(item) or fatal:
            return


class NativeMultibatchLoader(_DeviceSide):
    """MultibatchLoader on the C++ runtime (``data.native``): sampling,
    decode, resize and batch assembly on native worker threads, into
    pinned memory when the device is a card; augmentation on the
    device."""

    def __init__(self, cfg: DataLayerConfig,
                 transformer: Optional[TransformerConfig] = None,
                 train: bool = True, seed: int = 0, prefetch: int = 2,
                 threads: int = 4, device: DeviceLike = None):
        from npairloss_tpu_torch.data import native

        self._init_device(cfg, transformer, train, seed, device)
        self.dataset = native.NativeListFileDataset(
            cfg.root_folder, cfg.source, cfg.new_height, cfg.new_width)
        ids, imgs = _identity_counts(cfg)
        self._prefetcher = native.NativePrefetcher(
            self.dataset, ids, imgs, rand_identity=cfg.rand_identity,
            shuffle=cfg.shuffle, seed=seed, threads=threads,
            prefetch=prefetch, pin_memory=self.device.type == "cuda")

    def __iter__(self):
        return self

    def __next__(self):
        return self._to_device(*next(self._prefetcher))

    def close(self):
        self._prefetcher.close()
        self.dataset.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _maybe_augment(loader, images: torch.Tensor) -> torch.Tensor:
    """Augmentation only where the transform is not the default or a
    DataTransformer is set, from the loader's generator."""
    if (loader.cfg.transform == type(loader.cfg.transform)()
            and loader.transformer is None):
        return images
    return augment(images, loader.generator, tp=loader.cfg.transform,
                   transformer=loader.transformer, train=loader.train)


def multibatch_loader(cfg: DataLayerConfig,
                      transformer: Optional[TransformerConfig] = None,
                      train: Optional[bool] = None, seed: int = 0,
                      prefetch: int = 2, native: str = "auto",
                      device: DeviceLike = None):
    """The pipeline for a parsed MultibatchData layer.

    ``native``: "auto" takes the C++ runtime when it builds and the
    config can use it (fixed resize dims, and a list file whose entries
    all carry a suffix it decodes); "never" takes the Python pipeline;
    "require" raises where the native runtime is unavailable.  The
    Python pipeline reads whatever PIL reads; the native one JPEG (when
    linked with libjpeg) and PPM/PGM/BMP/uint8 NPY."""
    if train is None:
        train = cfg.phase == "TRAIN"
    if native not in ("auto", "never", "require"):
        raise ValueError(f"native must be auto/never/require, got {native!r}")
    if native != "never" and cfg.new_height and cfg.new_width:
        from npairloss_tpu_torch.data import native as nd

        if native == "require":
            nd.library()  # raises with the build's or the loader's error
        available = nd.native_available()
        try:
            if available and (
                    native == "require"
                    or _list_file_all_suffixed(cfg.source,
                                               nd.native_suffixes())):
                return NativeMultibatchLoader(
                    cfg, transformer, train=train, seed=seed,
                    prefetch=prefetch, device=device)
        except OSError:
            pass  # an unreadable list file: the Python path reports it
    elif native == "require":
        raise RuntimeError(
            "native loader requires new_height/new_width (fixed batch shape)")
    dataset = ListFileDataset(cfg.root_folder, cfg.source, cfg.new_height,
                              cfg.new_width)
    return MultibatchLoader(dataset, cfg, transformer, train=train,
                            seed=seed, prefetch=prefetch, device=device)


def shard_batches(batches: Iterator, rank: int, count: int) -> Iterator:
    """Per-process disjoint shards of a deterministic global batch stream
    (``npairloss_tpu/data/loader.py:326-366``): process ``rank`` gets rows
    ``[rank*n, (rank+1)*n)`` of every batch (``n = rows // count``).  The
    shards concatenated in rank order are the global batch, so the
    single-process run on the unsliced stream is the parity oracle.
    Loud on a batch whose rows do not divide by ``count``: a silently
    dropped remainder would change the pool every step.  Batches may be
    NumPy arrays or tensors (a loader's device batches, augmented
    whole before the slice)."""
    if not (0 <= int(rank) < int(count)):
        raise ValueError(f"rank {rank} outside [0, {count})")
    rank, count = int(rank), int(count)

    def gen():
        for inputs, labels in batches:
            rows = len(labels)
            if rows % count:
                raise ValueError(
                    f"global batch of {rows} rows does not divide over "
                    f"{count} processes; fix identity_num_per_batch x "
                    "img_num_per_identity to a multiple of the process "
                    "count")
            n = rows // count
            sl = slice(rank * n, (rank + 1) * n)
            yield inputs[sl], labels[sl]

    return gen()


def _list_file_all_suffixed(source: str, suffixes, sample: int = 4096) -> bool:
    """True when the list file's first ``sample`` entries all carry one of
    ``suffixes`` (a bounded look: lists run to millions of rows)."""
    seen = 0
    with open(source, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if not line.rsplit(None, 1)[0].lower().endswith(suffixes):
                return False
            seen += 1
            if seen >= sample:
                break
    return True
