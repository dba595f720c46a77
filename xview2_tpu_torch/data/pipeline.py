"""Host-side input pipeline: file discovery, index selection, decode, batch
(a copy of ``xview2_tpu/data/pipeline.py``, PIL decode only).

The host discovers files, decodes PNGs in a thread pool and assembles raw
uint8 batches; every per-pixel transform (crop, zoom, flip, noise,
normalize) runs on the device inside the train and eval steps.  The native
C++ decoder is not ported (ROADMAP Queue 1, the native PNG decoder).

Semantics preserved:
 * directory layout ``{data}/{train,test,holdout}/{images,targets}`` with
   ``*pre*`` / ``*post*`` sorted-glob pairing (``pytorch_loader.py:32-36``,
   ``data_module.py:12-14``),
 * train index restriction from ``index.csv`` (``data/index.py``),
 * train batches shuffled by a seed keyed on the loader's ``epoch``,
   ``drop_last``; eval batches sequential, last partial batch kept
   (``data_module.py:16-29``) and padded with a validity mask.

Under ``--gpus N`` every rank computes the same order and the same global
batches of ``N * batch_size`` samples (JAX's global batch); a rank loads and
decodes only its own ``batch_size`` rows of each, and ``drop_last`` and the
padding apply to the global batch.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from glob import glob
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image


def load_data(path: str, dtype: str) -> Tuple[List[str], List[str]]:
    """Sorted image/target pairing (reference pytorch_loader.py:32-36)."""
    imgs = sorted(glob(os.path.join(path, "images", f"*{dtype}*")))
    lbls = sorted(glob(os.path.join(path, "targets", f"*{dtype}*")))
    if len(imgs) != len(lbls) or not imgs:
        raise FileNotFoundError(f"no paired data under {path} for {dtype!r} "
                                f"({len(imgs)} imgs, {len(lbls)} lbls)")
    return imgs, lbls


def _decode_image(path: str) -> np.ndarray:
    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), np.uint8)
    return arr


def _decode_mask(path: str) -> np.ndarray:
    with Image.open(path) as im:
        arr = np.asarray(im, np.uint8)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr


@dataclass
class Batch:
    image: np.ndarray  # uint8 (B, H, W, 3|6)
    mask: np.ndarray   # uint8 (B, H, W)
    valid: np.ndarray  # float32 (B,)
    start: int = 0     # the position of row 0 in the loader's order (eval dump names)


class XView2Dataset:
    """Resolves the sample list for one split/task.

    ``cache_dir`` enables a raw-tile cache: the first read of a sample decodes
    the PNGs and writes one uncompressed ``.npy`` per sample; subsequent
    epochs ``np.load`` the raw bytes (no inflate, no filtering) — PNG decode
    is the host pipeline's only CPU-heavy stage.
    """

    def __init__(self, path: str, task_type: str, training: bool = False,
                 index_csv: Optional[str] = None, cache_dir: Optional[str] = None):
        self.task_type = task_type
        self.imgs_pre, self.lbls_pre = load_data(path, "pre")
        if task_type == "post" or not training:
            self.imgs_post, self.lbls_post = load_data(path, "post")
            if len(self.imgs_pre) != len(self.imgs_post):
                raise ValueError(f"{path}: {len(self.imgs_pre)} pre vs {len(self.imgs_post)} "
                                 "post images")
        if training and index_csv is not None:
            from xview2_tpu_torch.data.index import read_index_csv

            self.indices = read_index_csv(index_csv, task_type)
        else:
            self.indices = list(range(len(self.imgs_pre)))
        self.cache_dir = None
        if cache_dir:
            tag = f"{os.path.basename(os.path.abspath(path))}_{task_type}"
            self.cache_dir = os.path.join(cache_dir, tag)
            os.makedirs(self.cache_dir, exist_ok=True)

    def __len__(self) -> int:
        return len(self.indices)

    def item_paths(self, i: int):
        """(image paths, label path) for logical sample ``i``."""
        idx = self.indices[i]
        if self.task_type == "pre":
            return (self.imgs_pre[idx],), self.lbls_pre[idx]
        return (self.imgs_pre[idx], self.imgs_post[idx]), self.lbls_post[idx]

    def load_item(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        if self.cache_dir is not None:
            cpath = os.path.join(self.cache_dir, f"{self.indices[i]:08d}.npy")
            if os.path.exists(cpath):
                packed = np.load(cpath)
                return packed[..., :-1], packed[..., -1]
        img_paths, lbl_path = self.item_paths(i)
        imgs = [_decode_image(p) for p in img_paths]
        img = imgs[0] if len(imgs) == 1 else np.concatenate(imgs, axis=2)
        mask = _decode_mask(lbl_path)
        if self.cache_dir is not None:
            packed = np.concatenate([img, mask[..., None]], axis=2)
            tmp = f"{cpath}.{os.getpid()}.tmp.npy"  # np.save keeps .npy suffix
            np.save(tmp, packed)
            os.replace(tmp, cpath)
        return img, mask


class Loader:
    """Threaded batch loader with background prefetch.

    Train mode: per-epoch shuffle (seeded), drop_last.  Eval mode: sequential,
    final partial batch zero-padded with ``valid`` mask.  With ``world`` ranks
    a batch is rank ``rank``'s ``batch_size`` rows of the global batch of
    ``world * batch_size`` (a rank past the data gets a batch of padding),
    and ``len`` counts global batches.
    """

    def __init__(self, dataset: XView2Dataset, batch_size: int, *,
                 shuffle: bool, drop_last: bool, num_workers: int = 8,
                 seed: int = 0, prefetch: int = 2, rank: int = 0, world: int = 1):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.seed = seed
        self.prefetch = prefetch
        self.rank = rank
        self.world = world
        self.epoch = 0

    def __len__(self) -> int:
        n, g = len(self.ds), self.batch_size * self.world
        if self.drop_last:
            return n // g
        return -(-n // g)

    def _order(self) -> np.ndarray:
        order = np.arange(len(self.ds))
        if self.shuffle:
            rng = np.random.default_rng(self.seed * 100003 + self.epoch)
            rng.shuffle(order)
        return order

    def __iter__(self) -> Iterator[Batch]:
        order = self._order()
        self.epoch += 1
        n_batches = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        pool = ThreadPoolExecutor(max_workers=self.num_workers)

        def assemble(global_ids: Sequence[int], start: int) -> Batch:
            batch_ids = global_ids[self.rank * self.batch_size:][:self.batch_size]
            # a rank past the data decodes the global batch's first sample
            # for the shapes alone
            items = list(pool.map(self.ds.load_item, batch_ids if len(batch_ids)
                                  else global_ids[:1]))
            imgs = np.stack([it[0] for it in items])[:len(batch_ids)]
            msks = np.stack([it[1] for it in items])[:len(batch_ids)]
            valid = np.ones((len(batch_ids),), np.float32)
            pad = self.batch_size - len(batch_ids)
            if pad > 0:
                imgs = np.concatenate([imgs, np.zeros((pad,) + imgs.shape[1:], imgs.dtype)])
                msks = np.concatenate([msks, np.zeros((pad,) + msks.shape[1:], msks.dtype)])
                valid = np.concatenate([valid, np.zeros((pad,), np.float32)])
            return Batch(image=imgs, mask=msks, valid=valid, start=start)

        def put_or_stop(item) -> bool:
            """Bounded put that aborts when the consumer abandons the iterator.

            A plain ``q.put`` would block forever on a full queue once the
            consumer stops draining (early stop, exception) — leaking the
            producer thread, its decoded batch, and the pool every epoch.
            """
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                g = self.batch_size * self.world
                for b in range(n_batches):
                    if stop.is_set():
                        return
                    start = b * g + self.rank * self.batch_size
                    if not put_or_stop(assemble(order[b * g:(b + 1) * g], start)):
                        return
            finally:
                put_or_stop(None)
                pool.shutdown(wait=False)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                yield batch
        finally:
            stop.set()
            while True:  # unblock a producer mid-put, then let it exit
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=30.0)


def make_test_loader(cfg, rank: int = 0, world: int = 1) -> Loader:
    """The holdout loader of eval mode (reference data_module.py): sequential,
    last partial batch kept and padded; ``rank``'s rows of each global batch."""
    test_ds = XView2Dataset(os.path.join(cfg.data, "holdout"), cfg.type,
                            cache_dir=cfg.raw_cache)
    return Loader(test_ds, cfg.val_batch_size, shuffle=False, drop_last=False,
                  num_workers=cfg.num_workers, rank=rank, world=world)


def make_train_loaders(cfg, rank: int = 0, world: int = 1) -> Tuple[Loader, Loader]:
    """The train and validation loaders of train mode (the ``train`` and
    ``test`` splits), ``rank``'s rows of each global batch.  Training is
    ALWAYS index-restricted, as in the reference: without ``--index_csv`` the
    index is generated once under ``--results`` (``data/index.ensure_index``)."""
    from xview2_tpu_torch.data.index import ensure_index

    train_ds = XView2Dataset(os.path.join(cfg.data, "train"), cfg.type, True,
                             index_csv=ensure_index(cfg), cache_dir=cfg.raw_cache)
    val_ds = XView2Dataset(os.path.join(cfg.data, "test"), cfg.type, cache_dir=cfg.raw_cache)
    train = Loader(train_ds, cfg.batch_size, shuffle=True, drop_last=True,
                   num_workers=cfg.num_workers, seed=cfg.seed, rank=rank, world=world)
    val = Loader(val_ds, cfg.val_batch_size, shuffle=False, drop_last=False,
                 num_workers=cfg.num_workers, rank=rank, world=world)
    return train, val
