"""Durable atomic file publication.

Copy of ``llmd_kv_cache_tpu/utils/atomic_io.py``.

``os.replace`` alone gives atomicity against concurrent readers but not
against power loss: without an ``fsync`` of the tmp file the rename can
land on disk *before* the data blocks, publishing a torn file behind a
valid name, and without an ``fsync`` of the containing directory the
rename itself may vanish. Every persistence site in the project (snapshot
writer, offload run-config/object-store publication, checkpoint metadata)
goes through :func:`atomic_write_bytes` so the tmp + fsync(file) +
``os.replace`` + fsync(dir) sequence lives in exactly one place.
"""

from __future__ import annotations

import os
import threading


def fsync_dir(path: str) -> None:
    """fsync a directory so a rename inside it survives power loss.

    Best-effort: some filesystems (and all of Windows) refuse ``open`` on
    directories; the rename is still atomic there, just not durable.
    """
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Durably publish ``data`` at ``path``: tmp + fsync + replace + dirsync.

    The tmp name embeds pid and thread id so concurrent writers to the
    same target never collide on the intermediate file.
    """
    directory = os.path.dirname(os.path.abspath(path))
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:  # lint: allow-swallow (tmp already gone)
            pass
        raise
    fsync_dir(directory)
