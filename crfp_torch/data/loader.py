"""Host-side batching loader with background prefetch
(crfp_tpu/data/loader.py).

A thread pool in place of the reference's torch DataLoader workers: PIL
decode, the native resize and numpy crop/fovea release the GIL, so threads
keep the card fed without multiprocessing overhead; ``processes=True``
takes a pool of spawned processes instead. Batches are stacked NHWC numpy
arrays, as in the JAX package; the train step moves them to the device.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
from collections.abc import Iterator
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

_WORKER_DS = None


def _worker_init(ds):
    global _WORKER_DS
    _WORKER_DS = ds


def _worker_get(i):
    return _WORKER_DS[int(i)]


class Loader:
    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        num_workers: int = 4,
        drop_last: bool = True,
        prefetch: int = 2,
        seed: int = 0,
        processes: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.processes = processes
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> Iterator[list[int]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        for i in range(0, len(order), self.batch_size):
            idx = order[i : i + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield list(idx)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # gives up once the consumer has gone (a loop that broke early)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            if self.processes:
                # sidesteps the GIL for the numpy/fovea sample assembly;
                # the dataset is shipped once per worker via the initializer.
                # Spawned, not forked: the parent may hold a CUDA context
                pool = ProcessPoolExecutor(
                    self.num_workers, mp_context=multiprocessing.get_context("spawn"),
                    initializer=_worker_init, initargs=(self.dataset,),
                )
                get = _worker_get
            else:
                pool = ThreadPoolExecutor(self.num_workers)
                get = self.dataset.__getitem__
            try:
                with pool:
                    for idx in self._batches():
                        samples = list(pool.map(get, idx))
                        batch = {
                            k: np.stack([s[k] for s in samples]) for k in samples[0]
                        }
                        if not put(batch):
                            return
            except Exception as e:  # a reader's error: the consumer re-raises it
                put(e)
                return
            put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()


def get_dataloader(args) -> dict[str, Loader]:
    """The reference's dispatch: the train loader shuffled at
    args.batch_size, eval/test at batch 1."""
    name = args.dataset.lower()
    if name == "reds":
        from crfp_torch.data import reds as mod
    elif name in ("vimeo7", "vimeo"):
        from crfp_torch.data import vimeo as mod
    elif name == "procedural":
        # generated structured-content clips: train/eval/test end to end
        # without a dataset on disk (crfp_torch/data/procedural.py)
        from crfp_torch.data import procedural as mod
    else:
        raise SystemExit(f"Dataset '{args.dataset}' is not implemented")
    # training doesn't need LR_sr (y_only-only) or the pre-multiplied fovea
    # image: the model blends fvs*mk on device, so HR serves as fvs directly
    minimal = not getattr(args, "y_only", False)
    return {
        "train": Loader(
            mod.TrainSet(args, minimal=minimal), batch_size=args.batch_size,
            shuffle=True, num_workers=args.num_workers,
        ),
        "eval": Loader(mod.EvalSet(args), batch_size=1, num_workers=args.num_workers),
        "test": Loader(mod.TestSet(args), batch_size=1, num_workers=args.num_workers),
    }
