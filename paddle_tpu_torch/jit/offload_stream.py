"""The streaming lane and the group planner of optimizer offload (port of
the parts of ``paddle_tpu/jit/offload_stream.py`` that
``ShardedTrainStep``'s offload runs: ``plan_stream_groups``,
``StreamTransferError`` and ``StreamLane``).

:func:`plan_stream_groups` cuts the walk order of the offloaded tensors
into contiguous groups by their bytes, as the reference does: a group
closes once it holds ``segment_size`` bytes and never grows past
``buffer_max_size`` by adding a tensor.

:class:`StreamLane` moves one group's tensors between pinned host memory
and the card while the card computes. One worker thread issues the copies
of the submitted transfers, in order, with ``non_blocking=True`` on a CUDA
stream for each direction (uploads and downloads run at once, as the
link is duplex); a ``torch.cuda.Event`` marks each transfer's end. A
transfer starts after everything the submitting thread's current stream
had queued at the submit (an event recorded there), so a destination the
card still reads is not overwritten, and after the transfers named in
its ``after`` (one that reads the buffer it writes). ``handle.wait()`` makes the
consumer's current stream wait on the end event: it does not synchronise
the device; ``handle.synchronize()`` blocks the host until the bytes have
landed (a host read of a download). ``overlap=False`` runs the same copies
inline on the submitting stream. On CPU tensors (the tests) the copies
are plain ``copy_`` calls on the worker thread and ``wait()`` blocks the
host until they are done.

``stats()`` keeps the reference's counters: bytes each way, transfers,
``transfer_ms`` (each copy's device time, CUDA events), ``stall_ms``
(the time the consumer's stream waited on a transfer: from the wait to the
transfer's end, where positive; inline transfers stall for their whole
time), ``hidden_ms`` and ``overlap_efficiency`` = hidden / transfer time.
An error raised on the worker surfaces at the consumer's ``wait()`` as a
:class:`StreamTransferError`, and at every later submit.
"""
from __future__ import annotations

import queue
import threading
import time
import weakref
from typing import List, Optional, Sequence

import torch

__all__ = ["StreamLane", "StreamTransferError", "plan_stream_groups",
           "pinned_host_supported", "pin", "unpin"]

_PINNED = [None]  # whether CUDA can pin host memory here (probed once)


def pinned_host_supported() -> bool:
    """Whether host memory can be pinned for the card: CUDA is available
    and pinning one element works."""
    if _PINNED[0] is None:
        ok = False
        if torch.cuda.is_available():
            try:
                ok = torch.empty(1, pin_memory=True).is_pinned()
            except RuntimeError:
                ok = False
        _PINNED[0] = ok
    return _PINNED[0]


def _unregister(ptr: int) -> None:
    torch.cuda.cudart().cudaHostUnregister(ptr)


def pin(t: torch.Tensor) -> torch.Tensor:
    """``t`` (a contiguous CPU tensor) with its memory page-locked in place
    for the card's copies (``cudaHostRegister``: exact size, where torch's
    pinned allocator rounds a request up to a power of two); raises where
    CUDA cannot pin. :func:`unpin` releases the lock, as does ``t``'s
    collection (a finalizer, which holds no reference to ``t``)."""
    if not pinned_host_supported():
        raise RuntimeError("pin: CUDA cannot pin host memory here")
    if t.device.type != "cpu" or not t.is_contiguous():
        raise ValueError("pin takes a contiguous CPU tensor")
    nbytes = t.numel() * t.element_size()
    err = torch.cuda.cudart().cudaHostRegister(t.data_ptr(), nbytes, 0)
    if int(err) != 0:
        raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed: "
                           f"error {int(err)}")
    t._pt_unpin = weakref.finalize(t, _unregister, t.data_ptr())
    return t


def unpin(t: torch.Tensor) -> None:
    """Releases :func:`pin`'s lock on ``t`` now (the memory stays valid,
    pageable)."""
    fin = getattr(t, "_pt_unpin", None)
    if fin is not None:
        fin()


class StreamTransferError(RuntimeError):
    """A lane transfer failed. Carries the direction, the stream group's
    tag and the tensors' names, so the raise at the consumer's ``wait()``
    names what was in flight; the original exception is ``__cause__``."""

    def __init__(self, kind: str, tag, names, cause: BaseException):
        self.kind = kind
        self.tag = tag
        self.names = tuple(names or ())
        named = f" params={list(self.names)}" if self.names else ""
        super().__init__(
            f"stream transfer failed: kind={kind} group={tag}{named}: "
            f"{type(cause).__name__}: {cause}")
        self.__cause__ = cause


def plan_stream_groups(nbytes_list: Sequence[int],
                       segment_size: int = 2 ** 20,
                       buffer_max_size: int = 2 ** 23) -> List[List[int]]:
    """Partition tensors (given per-tensor byte sizes, walk order kept)
    into contiguous stream groups, the unit the lane moves and the update
    runs on. A group closes once it holds at least ``segment_size`` bytes;
    it never grows past ``buffer_max_size`` by adding a tensor (one tensor
    larger than the cap still gets a group of its own)."""
    segment_size = max(int(segment_size), 1)
    buffer_max_size = max(int(buffer_max_size), segment_size)
    groups: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i, nb in enumerate(nbytes_list):
        nb = int(nb)
        if cur and (cur_bytes + nb > buffer_max_size
                    or cur_bytes >= segment_size):
            groups.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
    if cur:
        groups.append(cur)
    return groups


class _TransferHandle:
    """One submitted transfer. ``wait()`` returns the destination tensors
    once the consumer may use them (see the module docstring)."""

    __slots__ = ("_issued", "_out", "_err", "_lane", "_end", "_device",
                 "_inline", "nbytes")

    def __init__(self, lane):
        self._issued = threading.Event()
        self._out = None
        self._err: Optional[BaseException] = None
        self._lane = lane
        self._end = None      # CUDA event at the transfer's end
        self._device = None   # the CUDA device it involves
        self._inline = False  # copied on the submitting stream
        self.nbytes = 0

    def done(self) -> bool:
        """Whether the transfer has landed (a host query)."""
        if not self._issued.is_set():
            return False
        return self._end is None or self._end.query()

    def wait_dispatched(self):
        """The destination tensors as soon as their copies are issued
        (without ordering the consumer's stream after them)."""
        if not self._issued.is_set():
            t0 = time.perf_counter()
            self._issued.wait()
            if self._end is None:
                self._lane._note_stall((time.perf_counter() - t0) * 1e3)
        if self._err is not None:
            raise self._err
        return self._out

    def wait(self):
        """The destination tensors; the consumer's current stream waits on
        the transfer's end (CPU tensors: the host waits)."""
        out = self.wait_dispatched()
        if self._end is not None and not self._inline:
            stream = torch.cuda.current_stream(self._device)
            req = torch.cuda.Event(enable_timing=True)
            req.record(stream)
            stream.wait_event(self._end)
            self._lane._note_wait(req, self._end)
        return out

    def synchronize(self):
        """The destination tensors once the bytes have landed: the host
        waits (a download read on the host)."""
        out = self.wait_dispatched()
        if self._end is not None:
            self._end.synchronize()
        return out


class StreamLane:
    """Double-buffered host <-> card transfer lane for stream groups.

    ``submit(kind, tensors, placement, tag)`` queues one group's copies:
    ``kind`` ``"h2d"`` (up to the card) or ``"d2h"`` (down to the host);
    ``placement`` a device (each tensor copied into a new tensor there,
    pinned on the host where CUDA can pin) or one destination tensor a
    source. The worker takes the queue in order; a submission blocks while
    ``depth`` are queued and not yet issued."""

    def __init__(self, overlap: bool = True, depth: int = 2):
        self.overlap = bool(overlap)
        self.depth = int(depth)
        self._lock = threading.Lock()
        self._stats = {"h2d_bytes": 0, "d2h_bytes": 0, "transfer_ms": 0.0,
                       "stall_ms": 0.0, "transfers": 0, "in_flight_sum": 0}
        self._timings: list = []  # (start, end) CUDA events not yet read
        self._waits: list = []    # (request, end) CUDA events not yet read
        self.events: List[tuple] = []  # (kind, tag) in submission order
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._thread: Optional[threading.Thread] = None
        self._streams = {}
        self._closed = False
        self._failure: Optional[BaseException] = None

    # -- submission -------------------------------------------------------------
    def submit(self, kind: str, tensors, placement, tag=None, names=None,
               after=()) -> _TransferHandle:
        if self._closed:
            raise RuntimeError("StreamLane is closed")
        if self._failure is not None:
            raise self._failure
        if kind not in ("h2d", "d2h"):
            raise ValueError(f"kind {kind!r}: 'h2d' or 'd2h'")
        tensors = list(tensors)
        handle = _TransferHandle(self)
        handle.nbytes = sum(t.numel() * t.element_size() for t in tensors
                            if isinstance(t, torch.Tensor))
        dev = next((t.device for t in tensors if isinstance(t, torch.Tensor)
                    and t.device.type == "cuda"), None)
        if dev is None and isinstance(placement, (list, tuple)):
            dev = next((t.device for t in placement
                        if isinstance(t, torch.Tensor)
                        and t.device.type == "cuda"), None)
        elif dev is None and placement is not None and \
                torch.device(placement).type == "cuda":
            dev = torch.device(placement)
        ready = None
        if dev is not None:
            handle._device = dev
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
        with self._lock:
            self.events.append((kind, tag))
            self._stats["in_flight_sum"] += self._q.qsize()
        job = (kind, tensors, placement, handle, tag, names, ready,
               tuple(h for h in after if h is not None))
        if not self.overlap:
            self._run_job(*job, inline=True)
            return handle
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True,
                                            name="pt-offload-stream")
            self._thread.start()
        self._q.put(job)
        if self._failure is not None and not handle._issued.is_set():
            # the worker died on an earlier job while this one queued
            handle._err = self._failure
            handle._issued.set()
        return handle

    def _stream(self, dev, kind):
        s = self._streams.get((dev, kind))
        if s is None:
            s = self._streams[(dev, kind)] = torch.cuda.Stream(dev)
        return s

    def _worker(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            self._run_job(*job)
            if self._failure is not None:
                while True:  # fail what is queued, then stop
                    try:
                        job = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if job is None:
                        break
                    job[3]._err = self._failure
                    job[3]._issued.set()
                return

    @staticmethod
    def _destinations(kind, tensors, placement):
        if isinstance(placement, (list, tuple)):
            if len(placement) != len(tensors):
                raise ValueError(f"{len(tensors)} tensors, {len(placement)} "
                                 f"destinations")
            return list(placement)
        if placement is None:
            raise ValueError("StreamLane.submit: give the destination "
                             "device or the destination tensors")
        dev = torch.device(placement)
        pin_it = kind == "d2h" and dev.type == "cpu" and \
            any(t.device.type == "cuda" for t in tensors)
        return [torch.empty(t.shape, dtype=t.dtype, device=dev,
                            pin_memory=pin_it) for t in tensors]

    def _run_job(self, kind, tensors, placement, handle, tag, names, ready,
                 after=(), inline=False):
        dev = handle._device
        t0 = time.perf_counter()
        try:
            out = self._destinations(kind, tensors, placement)
            for h in after:  # issued before this job: their events exist
                if h._err is not None:
                    raise h._err
            if dev is None:
                for d, s in zip(out, tensors):
                    d.copy_(s)
            else:
                stream = torch.cuda.current_stream(dev) if inline \
                    else self._stream(dev, kind)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    stream.wait_event(ready)
                    for h in after:
                        if h._end is not None:
                            stream.wait_event(h._end)
                    start.record(stream)
                    for d, s in zip(out, tensors):
                        d.copy_(s, non_blocking=True)
                    end.record(stream)
                handle._end, handle._inline = end, inline
                with self._lock:
                    self._timings.append((start, end, inline))
            handle._out = out
            nbytes = handle.nbytes
        except BaseException as e:  # surfaces at the consumer's wait()
            err = StreamTransferError(kind, tag, names, e)
            handle._err = err
            self._failure = err
            nbytes = 0
        ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self._stats[f"{kind}_bytes"] += nbytes
            self._stats["transfers"] += 1
            if dev is None:
                self._stats["transfer_ms"] += ms
                if inline:  # the consumer waited for all of it
                    self._stats["stall_ms"] += ms
        handle._issued.set()

    def _note_stall(self, ms: float):
        with self._lock:
            self._stats["stall_ms"] += ms

    def _note_wait(self, req, end):
        with self._lock:
            self._waits.append((req, end))

    def _resolve(self):
        """Reads the CUDA events of finished transfers into the counters
        (a host wait for any still in flight)."""
        with self._lock:
            timings, self._timings = self._timings, []
            waits, self._waits = self._waits, []
        for start, end, inline in timings:
            end.synchronize()
            ms = start.elapsed_time(end)
            self._stats["transfer_ms"] += ms
            if inline:  # the consumer waited for all of it
                self._stats["stall_ms"] += ms
        for req, end in waits:
            end.synchronize()
            req.synchronize()
            self._stats["stall_ms"] += max(req.elapsed_time(end), 0.0)

    # -- reads ------------------------------------------------------------------
    def stats(self) -> dict:
        self._resolve()
        with self._lock:
            s = dict(self._stats)
        s["overlap"] = self.overlap
        s["hidden_ms"] = max(s["transfer_ms"] - s["stall_ms"], 0.0)
        s["overlap_efficiency"] = round(
            s["hidden_ms"] / s["transfer_ms"], 4) if s["transfer_ms"] else 0.0
        return s

    def reset_stats(self) -> None:
        self._resolve()
        with self._lock:
            for k in self._stats:
                self._stats[k] = 0 if isinstance(self._stats[k], int) else 0.0
            self.events = []

    def close(self) -> None:
        self._closed = True
        t, self._thread = self._thread, None
        if t is not None:
            self._q.put(None)
            t.join()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
