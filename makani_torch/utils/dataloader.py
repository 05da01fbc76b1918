"""Dataloader front end (counterpart of ``makani_tpu/utils/dataloader.py``)
for one process.

``get_dataloader`` picks the dataset (the multifiles HDF5 one, or the
synthetic one) and wraps it in ``BatchIterator``, which yields numpy
batches in the JAX package's order and layout:

    inp: (B, (n_history+1)*C, H, W)    the history window, normalized
    tar: (B, (n_future+1)*C, H, W)     the future steps, normalized
    zen: (B, n_history+1+n_future, 1, H, W)  the zenith angle of each window step
    tzen: (B, n_future+1, 1, H, W)     the targets' zenith angles

``DeviceBatches`` puts those batches on the card. Its worker thread
assembles each batch straight into page-locked (pinned) staging buffers, a
ring of two; the copy to the card is issued from them with
``non_blocking`` on a side stream and the compute stream waits on its
event, so the read of batch i + 1 and its copy overlap step i. It keeps
the host's and the copies' time for the drivers' account (``stats``).
"""

from __future__ import annotations

import concurrent.futures as cf
import time
from typing import Iterator

import numpy as np
import torch

__all__ = ["get_dataloader", "BatchIterator", "DeviceBatches"]


def _assemble(samples, alloc=None):
    """Stack samples into a batch; ``alloc(key, shape)`` gives the fp32
    buffer each of inp, tar, zen and tzen is stacked into (else new
    arrays)."""

    def stack(key, arrays):
        if alloc is None:
            return np.stack(arrays)
        return np.stack(arrays, out=alloc(key, (len(arrays), *arrays[0].shape)))

    inp = stack("inp", [s["inp"] for s in samples])  # (B, T, C, H, W)
    tar = stack("tar", [s["tar"] for s in samples])
    B, T, C, H, W = inp.shape
    Bt, Tt, Ct, _, _ = tar.shape
    batch = {"inp": inp.reshape(B, T * C, H, W), "tar": tar.reshape(Bt, Tt * Ct, H, W)}
    if "izen" in samples[0]:
        izen = np.stack([s["izen"] for s in samples])  # (B, T, 1, H, W)
        tzen = stack("tzen", [s["tzen"] for s in samples])  # (B, T', 1, H, W)
        parts = [izen, tzen[:, :-1]] if tzen.shape[1] > 1 else [izen]
        if alloc is None:
            zen = np.concatenate(parts, axis=1) if len(parts) > 1 else izen
        else:
            zen = np.concatenate(parts, axis=1, out=alloc("zen", (B, sum(p.shape[1] for p in parts), *izen.shape[2:])))
        batch["zen"] = zen
        batch["tzen"] = tzen
    return batch


def prefetched(dataset, index_batches, stage=None) -> Iterator[dict]:
    """Assembled batches of ``dataset`` for each list of indices, read one
    ahead on a worker thread; ``stage()``, where given, is called on that
    thread before each batch and returns the batch's ``alloc``."""

    def fetch(batch_idx):
        t0 = time.perf_counter()
        samples = [dataset[int(i)] for i in batch_idx]
        t1 = time.perf_counter()
        batch = _assemble(samples, stage() if stage is not None else None)
        return batch, t1 - t0, time.perf_counter() - t1

    with cf.ThreadPoolExecutor(max_workers=1) as pool:
        nxt = pool.submit(fetch, index_batches[0]) if index_batches else None
        for i in range(len(index_batches)):
            cur = nxt
            nxt = pool.submit(fetch, index_batches[i + 1]) if i + 1 < len(index_batches) else None
            yield cur.result()


class BatchIterator:
    """Shuffling batch iterator with a one-batch host prefetch. The order of
    an epoch is ``RandomState(seed + epoch)``'s permutation; each pass
    advances the epoch, and ``set_epoch`` pins it (the trainer pins it to the
    global epoch, so a restart resumes the same sequence)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 333, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def index_batches(self) -> list:
        """This pass's batches of dataset indices; advances the epoch."""
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        self.epoch += 1
        batches = [idx[i : i + self.batch_size] for i in range(0, n - self.batch_size + 1, self.batch_size)]
        if not self.drop_last and n % self.batch_size:
            batches.append(idx[-(n % self.batch_size):])
        return batches

    def __iter__(self) -> Iterator[dict]:
        for batch, _, _ in prefetched(self.dataset, self.index_batches()):
            yield batch


class _Slot:
    """One set of pinned staging buffers and the event of its last copy."""

    def __init__(self):
        self.buffers: dict = {}
        self.copied = None

    def alloc(self, key, shape):
        t = self.buffers.get(key)
        if t is None or tuple(t.shape) != tuple(shape):
            t = self.buffers[key] = torch.empty(shape, dtype=torch.float32, pin_memory=True)
        return t.numpy()


class DeviceBatches:
    """The batches of a host iterator (``BatchIterator``, or the lists of
    indices ``index_batches`` of a dataset) as tensors on ``device``. On a
    CUDA device through pinned staging and side-stream copies (module
    docstring); on the CPU the numpy batches as tensors.

    ``stats()`` after a pass: the seconds the worker spent reading samples
    and assembling them into the staging buffers, the dataset's own
    ``timings`` (read, normalize, zenith), and each copy's device time."""

    SLOTS = 2

    def __init__(self, loader, device, dataset=None, index_batches=None):
        self.loader = loader
        self.dataset = dataset if dataset is not None else loader.dataset
        self._index_batches = index_batches
        self.device = torch.device(device)
        self._slots = [_Slot() for _ in range(self.SLOTS)] if self.device.type == "cuda" else None
        self._stream = None
        self.reset_stats()

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self._index_batches) if self._index_batches is not None else len(self.loader)

    def reset_stats(self):
        self.fetch_seconds, self.stage_seconds, self.copies, self.n_batches = 0.0, 0.0, [], 0
        timings = getattr(self.dataset, "timings", None)
        self._timings0 = dict(timings) if timings is not None else {}

    def stats(self) -> dict:
        """Host seconds and copy milliseconds summed over the batches since
        ``reset_stats`` (the copies' events must have completed)."""
        timings = getattr(self.dataset, "timings", None) or {}
        out = {"batches": self.n_batches, "fetch_s": self.fetch_seconds, "stage_s": self.stage_seconds}
        out.update({f"{k}_s": v - self._timings0.get(k, 0.0) for k, v in timings.items()})
        out["copy_ms"] = sum(s.elapsed_time(e) for s, e in self.copies)
        return out

    def _stage(self):
        slot = self._slots[self._staged % self.SLOTS]
        self._staged += 1
        if slot.copied is not None:
            slot.copied.synchronize()  # the copy that last read this slot
        return slot.alloc

    def __iter__(self) -> Iterator[dict]:
        batches = self._index_batches if self._index_batches is not None else self.loader.index_batches()
        cuda = self._slots is not None
        self._staged = 0
        if cuda and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        for k, (batch, fetch_s, stage_s) in enumerate(prefetched(self.dataset, batches, self._stage if cuda else None)):
            self.fetch_seconds += fetch_s
            self.stage_seconds += stage_s
            self.n_batches += 1
            if not cuda:
                yield {key: torch.from_numpy(v) for key, v in batch.items()}
                continue
            main = torch.cuda.current_stream(self.device)
            start, done = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(self._stream):
                start.record()
                out = {key: torch.from_numpy(v).to(self.device, non_blocking=True) for key, v in batch.items()}
                done.record()
            self._slots[k % self.SLOTS].copied = done
            self.copies.append((start, done))
            main.wait_event(done)
            for t in out.values():
                t.record_stream(main)
            yield out


def get_dataloader(params, location: str, mode: str = "train", final_eval: bool = False):
    """(BatchIterator, dataset) for one process; ``data_loader_config``
    "grain" is not ported and raises."""
    train = mode == "train"
    if params.get("enable_synthetic_data", False) or params.get("data_loader_config", None) == "synthetic":
        from makani_torch.utils.dataloaders.data_loader_dummy import DummyDataset

        dataset = DummyDataset(params, location, train=train, final_eval=final_eval)
    else:
        if params.get("data_loader_config", "threaded") == "grain":
            raise NotImplementedError("data_loader_config 'grain' is not ported (the port's loader is the threaded BatchIterator)")
        from makani_torch.utils.dataloaders.data_loader_multifiles import MultifilesDataset

        dataset = MultifilesDataset(params, location, train=train, final_eval=final_eval)
    return BatchIterator(dataset, batch_size=params.get("batch_size", 1), shuffle=train, seed=params.get("seed", 333)), dataset
