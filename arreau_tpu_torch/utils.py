"""Small runtime utilities shared by the CLIs; counterpart of
``arreau_tpu/utils.py`` (a copy of ``prefetch``). ``enable_compilation_cache``
has no counterpart: the port compiles its kernels once into
``build/arreau_tpu_torch/`` (``kernels/build.py``)."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

import torch

_T = TypeVar("_T")


def prefetch(iterable: Iterable[_T], depth: int = 2) -> Iterator[_T]:
    """Host/device overlap: pull items from ``iterable`` in a background
    (daemon) thread, keeping up to ``depth`` ready ahead of the consumer, in
    order; an exception of the worker is raised on the consumer's side after
    the items before it. Wrap an iterator whose ``__next__`` collates (and
    copies to the device) so that the next batch is staged while the card
    runs the current step."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    err: list[BaseException] = []

    def worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            q.put(done)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is done:
            if err:
                raise err[0]
            return
        yield item


def prefetch_to_device(host_batches: Iterable, to_device, device, depth: int = 2) -> Iterator:
    """:func:`prefetch` of ``to_device(host_batch, device, non_blocking)`` for
    each host batch, in order: the worker thread collates (iterating
    ``host_batches``) and copies. On CUDA it copies from pinned host memory
    on a stream of its own (``non_blocking=True``); the consumer's stream
    waits for each batch's copy and records its use of the batch's tensors,
    so the allocator keeps them until the consumer's work is done. On any
    other device it calls ``to_device(host_batch, device, False)``."""
    device = torch.device(device)
    if device.type != "cuda":
        yield from prefetch((to_device(host, device, False) for host in host_batches), depth)
        return
    copy_stream = torch.cuda.Stream(device)

    def staged():
        for host in host_batches:
            with torch.cuda.stream(copy_stream):
                batch = to_device(host, device, True)
                ready = torch.cuda.Event()
                ready.record(copy_stream)
            yield batch, ready

    for batch, ready in prefetch(staged(), depth):
        current = torch.cuda.current_stream(device)
        current.wait_event(ready)
        for t in batch:
            t.record_stream(current)
        yield batch
