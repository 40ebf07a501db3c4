"""Host-side prefetching: overlap batch assembly with device compute
(counterpart of ``sm_hpss_mtl_tpu/data/prefetch.py``).

Worker threads pull batches from host iterators, turn their numpy arrays
into tensors on the target device and keep a small bounded queue of them.
On CUDA each array is copied into a fresh pinned buffer and sent with
``non_blocking=True``: the copy overlaps the step that runs, and PyTorch's
pinned-memory allocator does not hand a buffer out again before the copy
that reads it has finished.  The copies go on the worker's current stream,
the default one, so a step the consumer launches after taking the batch
runs after its copy.  On the CPU the arrays become tensors without a copy.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..device import resolve_device
from ..utils.profiling import span


def to_device(tree, device: torch.device):
    """Numpy arrays (and tensors) of a nested dict/tuple/list on
    ``device``; pinned, non-blocking copies on CUDA."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_device(v, device) for v in tree)
    t = torch.as_tensor(np.ascontiguousarray(tree)
                        if isinstance(tree, np.ndarray) else tree)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class DevicePrefetcher:
    """Wrap host batch iterator(s); yields batches on ``device``.

    Pass a list of independent iterators (several ``BalancedBatcher``s
    with different seeds) to run several host pipelines; each gets its own
    thread and batches interleave in completion order.  An error in a
    worker is raised on the consumer side, after the batches queued before
    it.
    """

    _SENTINEL = object()

    def __init__(self, iterator, device: str | torch.device = "cuda",
                 buffer_size: int = 2):
        iterators = (iterator if isinstance(iterator, (list, tuple))
                     else [iterator])
        self.device = resolve_device(device)
        self.q: queue.Queue = queue.Queue(
            maxsize=max(buffer_size, len(iterators)))
        self.error: BaseException | None = None
        self._closed = False
        self._lock = threading.Lock()
        self._live = len(iterators)
        self.threads = [threading.Thread(target=self._worker, args=(it,),
                                         daemon=True) for it in iterators]
        for t in self.threads:
            t.start()

    def _put(self, item) -> bool:
        """Bounded put that gives up once the consumer closed us."""
        while not self._closed:
            try:
                self.q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, iterator):
        try:
            for batch in iterator:
                if self._closed or not self._put(to_device(batch,
                                                           self.device)):
                    break
        except Exception as e:  # raised by the consumer's next __next__
            self.error = e
            self._put(self._SENTINEL)
        finally:
            with self._lock:
                self._live -= 1
                last = self._live == 0
            if last and self.error is None:
                self._put(self._SENTINEL)

    def close(self, timeout: float = 60.0):
        """Stop the workers and wait for them; safe to call more than once.
        A worker blocked on the full queue sees the flag within 0.5 s; one
        assembling a batch finishes it first (so no work of this
        prefetcher, such as a kernel launch, runs after ``close``)."""
        self._closed = True
        while True:
            try:
                self.q.get_nowait()
            except queue.Empty:
                break
        for t in self.threads:
            t.join(timeout)

    def __iter__(self):
        return self

    def __next__(self):
        with span("stream.wait"):
            item = self.q.get()
        if item is self._SENTINEL:
            if self.error is not None:
                raise self.error
            raise StopIteration
        return item
