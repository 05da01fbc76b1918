#!/usr/bin/env python3
"""The training loader's read of one 0.25-degree state, timed on the host:

    python3 sweep_read.py [rounds]     # default 8 rounds

``MultifilesDataset._read_window`` (each time step copied from the file's
memory map into one fp32 buffer, converted as it is copied), the same
window read by the native pread reader (``MAKANI_NATIVE_READER=1``) with 4
threads (the default) and with 8 (``MAKANI_NATIVE_THREADS``), and the plain
full-slab copy (``np.copyto`` of ``mm[i]`` into a preallocated buffer), on
the same file and the same states, in rounds whose order alternates. The
files are the seeded year files of ``chip_smoke.py``'s driver phases
(``driver_files``: 5 states of 73 x 721 x 1440 fp32 a file), written under
a temporary directory in ``build/`` and removed at exit; the reads are warm
(the page cache holds the file just written). The reads are held bit for
bit to each other. Prints the median ms and GB/s of each, every read, and
the host's CPU count; the card, where there is one, only generates the
files.
"""

from __future__ import annotations

import os
import shutil
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke


def slab_copy(mm, indices):
    """The removed full-grid branch: one ``np.copyto`` a time step."""
    out = np.empty((len(indices),) + mm.shape[1:], np.float32)
    for k, i in enumerate(indices):
        np.copyto(out[k], mm[i])
    return out


def main(rounds: int = 8) -> int:
    from makani_torch.utils.dataloaders.data_loader_multifiles import MultifilesDataset
    from makani_torch.utils.parse_dataset_metadata import parse_dataset_metadata
    from makani_torch.utils.yparams import YParams

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    card = chip_smoke.card_line() if dev.type == "cuda" else "no card"
    root = tempfile.mkdtemp(prefix="sweep_read_", dir=os.path.join(chip_smoke.REPO, "build"))
    try:
        path, _ = chip_smoke.driver_files(root, dev)
        params = YParams(path, chip_smoke.DRIVER_NAME)
        parse_dataset_metadata(params["metadata_json_path"], params)
        ds = MultifilesDataset(params, params["train_data_path"], train=True)
        native = {}
        for threads in (4, 8):
            os.environ.update(MAKANI_NATIVE_READER="1", MAKANI_NATIVE_THREADS=str(threads))
            try:
                native[threads] = MultifilesDataset(params, params["train_data_path"], train=True)
            finally:
                del os.environ["MAKANI_NATIVE_READER"], os.environ["MAKANI_NATIVE_THREADS"]
        mm = ds._datasets[0].memmap()
        channels = list(range(mm.shape[1]))
        states = [[i] for i in range(mm.shape[0])]
        nbytes = mm[0].nbytes
        reads = {"_read_window": lambda idx: ds._read_window(0, idx, channels),
                 **{f"native pread ({n} threads)": (lambda idx, d=d: d._read_window(0, idx, channels)) for n, d in native.items()},
                 "np.copyto slabs": lambda idx: slab_copy(mm, idx)}
        for idx in states:  # warm all, and hold them to each other
            a, *rest = (fn(idx) for fn in reads.values())
            if not all(np.array_equal(a, b) for b in rest):
                raise RuntimeError(f"the reads differ at state {idx}")
        ms = {name: [] for name in reads}
        for p in range(rounds):
            order = list(reads) if p % 2 == 0 else list(reads)[::-1]
            for name in order:
                for idx in states:
                    t0 = time.perf_counter()
                    reads[name](idx)
                    ms[name].append(1e3 * (time.perf_counter() - t0))
        for name, v in ms.items():
            med = statistics.median(v)
            print(f"{name}: median {med:.1f} ms a state of {nbytes / 1e6:.1f} MB ({nbytes / 1e6 / med:.3f} GB/s), quartiles "
                  f"{np.percentile(v, 25):.1f} / {np.percentile(v, 75):.1f} ms, {len(v)} reads; all {[round(x, 1) for x in v]}  "
                  f"[{os.cpu_count()} CPUs; {card}]", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:])))
