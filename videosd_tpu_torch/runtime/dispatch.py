"""Single-threaded dispatch worker with pipelining: the port's copy of
``videosd_tpu/runtime/dispatch.py`` (stdlib only; held equal by
``tests/test_torch_port_copies.py``).

Every program execution of the serving path funnels through this worker:
it dispatches up to ``depth`` programs before blocking on the oldest
result, so host packing overlaps device work with exactly one thread
launching the serving programs.  (Background warm-ups and CUDA graph
captures run on their own threads; see ``runtime/engine_warmup.py``.)
"""

from __future__ import annotations

import collections
import queue
import threading

__all__ = ["DispatchWorker"]


class DispatchWorker:
    _STOP = object()

    def __init__(self, depth: int = 2):
        self.depth = max(1, depth)
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(
            target=self._loop, name="tpu-dispatch", daemon=True
        )
        self._thread.start()

    def run(self, loop, dispatch, finalize):
        """Schedule ``finalize(dispatch())`` on the worker; returns an
        asyncio future (resolved via ``loop``).

        ``dispatch`` must only enqueue device work (JAX async dispatch —
        returns immediately); ``finalize`` may block on results.
        """
        fut = loop.create_future()
        self._q.put((loop, fut, dispatch, finalize))
        return fut

    def stop(self, timeout: float = 30.0):
        self._q.put(self._STOP)
        self._thread.join(timeout=timeout)

    @staticmethod
    def _resolve(loop, fut, result=None, exc=None):
        def setter():
            if fut.cancelled():
                return
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)

        try:
            loop.call_soon_threadsafe(setter)
        except RuntimeError:  # loop already closed (shutdown race)
            pass

    def _finalize_one(self, pending):
        loop, fut, raw, finalize = pending.popleft()
        try:
            res = finalize(raw)
        except Exception as e:  # noqa: BLE001 - surfaced via the future
            self._resolve(loop, fut, exc=e)
        else:
            self._resolve(loop, fut, result=res)

    def _loop(self):
        pending: collections.deque = collections.deque()
        while True:
            try:
                item = self._q.get(
                    block=True, timeout=0.002 if pending else None
                )
            except queue.Empty:
                # no new work: drain the oldest in-flight program
                self._finalize_one(pending)
                continue
            if item is self._STOP:
                while pending:
                    self._finalize_one(pending)
                return
            loop, fut, dispatch, finalize = item
            try:
                raw = dispatch()
            except Exception as e:  # noqa: BLE001
                self._resolve(loop, fut, exc=e)
                continue
            pending.append((loop, fut, raw, finalize))
            while len(pending) > self.depth:
                self._finalize_one(pending)
