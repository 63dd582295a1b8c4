"""Locked-atomic-JSON read-merge-write — one shared persistence helper
(reference: ``core/locked_json.py``, of which this is a copy).

Both persistent artifacts of the tuning stack follow the same
concurrent-writer discipline: the plan cache
(:meth:`repro_torch.core.autotune.PlanCache.save`) and the fitted roofline
constants (:func:`repro_torch.roofline.calibrate.record_samples`) may be
written simultaneously by several tuning processes sharing the default
paths.  Each write
must therefore

  1. take an exclusive advisory lock (``path + ".lock"``, ``fcntl.flock``
     — best-effort on platforms without it),
  2. RE-READ the file under the lock (another writer may have updated it
     since this process last loaded),
  3. merge its own changes into the fresh contents,
  4. write atomically (tempfile in the same directory + ``os.replace``)
     so readers never observe a torn file, and crashes never lose the
     previous version.

:func:`locked_update` is that dance, once; callers supply only the merge
step.  Corrupt or missing files read as ``None`` — merge functions treat
that as "start fresh", so a damaged file is repaired rather than fatal.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Callable


def read_json(path: str) -> dict | None:
    """Best-effort JSON read: a missing, unreadable or corrupt file reads
    as ``None`` (the caller re-creates it on the next write)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def locked_update(path: str, merge: Callable[[dict | None], dict],
                  on_written: Callable[[], None] | None = None,
                  indent: int = 1) -> dict:
    """Read-merge-write ``path`` atomically under an exclusive lock.

    ``merge`` receives the current file contents (``None`` if missing or
    corrupt) and returns the full payload to persist.  ``on_written``
    (optional) runs after the atomic replace while the lock is still
    held — e.g. to snapshot the file's mtime without racing a later
    writer.  Returns the payload written."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path + ".lock", "w") as lk:
        try:
            import fcntl
            fcntl.flock(lk, fcntl.LOCK_EX)
        except (ImportError, OSError):
            pass                        # best-effort on odd platforms
        payload = merge(read_json(path))
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=indent)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        if on_written is not None:
            on_written()
    return payload
