"""The GlobalGraph backend on its own worker thread (port of
`lv_slam_tpu.pipeline.async_backend`).

The reference's backend is a ROS nodelet whose optimization runs on a timer
thread that never blocks the odometry (`global_graph_nodelet.cpp:670-764`).
`AsyncBackend` owns a `GlobalGraph` and one worker thread that consumes a
FIFO queue, so the backend's host work (keyframe gates, window bookkeeping,
the verification and LM reads) overlaps the producer's kernel launches.
Results equal the synchronous backend's: one consumer runs the calls in
order, and after the first enqueue only the worker touches the graph.
`join()` is the one synchronization point and re-raises what the worker
raised; after it the services (`dump`, `save_map`, `save_pose`) and every
read of the graph go to the wrapped `GlobalGraph` through `__getattr__`, as
in the reference.

CUDA work from two threads: both use the device's default stream (torch's
current stream is per thread, and neither thread changes it), so the
worker's kernels queue behind the producer's in launch order, and a tensor
the producer hands over is complete before the worker's kernels read it.
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

from lv_slam_tpu_torch.pipeline.backend import GlobalGraph

__all__ = ["AsyncBackend"]


class AsyncBackend:
    """Thread-backed facade over a `GlobalGraph`: `add_scan_batch`,
    `optimize`, `finish` and `submit` enqueue; `drain()` enqueues the drain
    and joins. After `join()` the wrapped graph is the caller's again."""

    def __init__(self, backend: GlobalGraph, max_pending: int = 8):
        self.graph_backend = backend
        # bounded: a stalled worker applies back-pressure
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name="lv-slam-backend", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                fn, args, kwargs = item
                if self._exc is None:  # after a failure, drain the rest unrun
                    if callable(fn):
                        fn(*args, **kwargs)
                    else:
                        getattr(self.graph_backend, fn)(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 -- re-raised at join()
                self._exc = e
            finally:
                self._q.task_done()

    def _submit(self, fn, *args, **kwargs) -> None:
        if self._exc is not None:
            self.join()  # re-raises
        if not self._thread.is_alive():
            raise RuntimeError("AsyncBackend worker already joined")
        self._q.put((fn, args, kwargs))

    def submit(self, fn, *args, **kwargs) -> None:
        """Run an arbitrary callable on the worker, in order with the
        backend calls (a caller moves its pose read there)."""
        self._submit(fn, *args, **kwargs)

    def add_scan_batch(self, *args, **kwargs) -> None:
        self._submit("add_scan_batch", *args, **kwargs)

    def optimize(self, *args, **kwargs) -> None:
        """Enqueue one optimization cycle; its result shows after `join()`."""
        self._submit("optimize", *args, **kwargs)

    def finish(self) -> None:
        self._submit("finish")

    def drain(self) -> None:
        """Enqueue the backend drain, then join the worker."""
        self._submit("drain")
        self.join()

    def join(self) -> None:
        """Wait until the queue is done and the worker has exited; re-raise
        any worker exception."""
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join()
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def __getattr__(self, name):
        # reads of the wrapped graph (keyframes, loops, timings, ...): safe
        # after join()
        return getattr(self.graph_backend, name)
