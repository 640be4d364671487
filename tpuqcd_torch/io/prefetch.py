"""Background gauge-configuration read-ahead for ensemble runs.

Counterpart of ``tpuqcd/io/prefetch.py``.  In an ensemble run
(cli/common.ensemble_members) the next member's ILDG file is read on a
background thread while the card measures the current member.  The
thread does host work only: the file read and the checksum
(io/lime.read_ildg_payload).  It makes no CUDA call, so it never
synchronises the stream of the member being measured; the decode to the
device layout runs on the card when the member's setup_gauge takes the
payload (io/native.ildg_payload_to_device).

``prefetch(path)`` as early as possible (idempotent while that read is in
flight); ``take(path)`` where the payload is needed: it joins the thread,
or falls through to a synchronous read if the path was never prefetched.
An error in the thread, a checksum mismatch included, is raised at take.
``prefetch_after(path, next_path)`` starts next_path's read once
take(path) has its payload, so that two checksum loops never contend for
the interpreter lock (the first member's synchronous read would wait on
the second's read-ahead).
"""
from __future__ import annotations

import threading

from .lime import IldgPayload, read_ildg_payload

_lock = threading.Lock()
_pending: dict = {}     # path -> (thread, box)
_after: dict = {}       # path -> the path to prefetch once take(path) has its payload


def prefetch(path: str) -> None:
    """Start reading ``path`` on a background thread (idempotent)."""
    with _lock:
        if path in _pending:
            return
        box: dict = {}

        def work():
            try:
                box["result"] = read_ildg_payload(path)
            except Exception as e:              # raised at take()
                box["error"] = e

        t = threading.Thread(target=work, name=f"ildg-prefetch:{path}", daemon=True)
        _pending[path] = (t, box)
        t.start()


def prefetch_after(path: str, next_path: str) -> None:
    """prefetch(next_path) as soon as take(path) has returned its payload."""
    with _lock:
        _after[path] = next_path


def take(path: str) -> IldgPayload:
    """The verified payload of ``path``: the prefetched one if a read is in
    flight or done (joining it), else a synchronous read; then the read
    that prefetch_after queued behind ``path`` starts."""
    with _lock:
        entry = _pending.pop(path, None)
    if entry is None:
        result = read_ildg_payload(path)
    else:
        t, box = entry
        t.join()
        if "error" in box:
            raise box["error"]
        if "result" not in box:
            raise RuntimeError(f"the read-ahead of {path} ended without a result")
        result = box["result"]
    with _lock:
        next_path = _after.pop(path, None)
    if next_path is not None:
        prefetch(next_path)
    return result
