"""Evictor pipeline: activator → crawlers → deleter → folder cleaner.

Copy of ``llmd_kv_cache_tpu/evictor/evictor.py``. ``usage_fn`` and
``publisher`` stay injectable: any object with ``publish_block_removed``
serves, such as one that hands the encoded batch to an event ``Pool``'s
``add_task`` on a host without ``zmq``.

Counterpart of reference ``pvc_evictor/evictor.py`` + ``processes/``:

- **activator**: polls disk usage; deletion switches ON above
  ``cleanup_threshold`` and OFF below ``target_threshold`` (hysteresis)
- **crawlers**: partition the 16 first-hex buckets across workers
  (``crawler.py:49-79`` equivalent) and stream candidate files oldest-atime
  first, skipping anything accessed within ``min_idle_seconds``
- **deleter**: deletes in batches, parses ``(block_hash, group)`` from the
  path via ``FileMapper.parse_block_path`` and publishes ``BlockRemoved``
  storage events so the global index drops the storage-tier entries
- **folder cleaner**: prunes empty bucket directories with a TTL guard
  against racing writers

The reference runs these as N+2 supervised OS processes; here they are
supervised daemon threads (the work is I/O-bound and the index events are
the shared state, so threads suffice; the supervisor restarts dead
workers the same way, ``evictor.py:135+``). Each stage is also exposed as
a plain function for deterministic tests.
"""

from __future__ import annotations

import heapq
import os
import shutil
import threading
import time
from typing import Callable, Iterator, Optional, Sequence

from ..events.publisher import StorageEventPublisher
from ..offload.file_mapper import FileMapper
from ..utils.lockdep import new_lock
from ..utils.logging import get_logger
from .config import EvictorConfig

logger = get_logger("evictor")

_HEX = "0123456789abcdef"


def disk_usage_fraction(path: str) -> float:
    usage = shutil.disk_usage(path)
    return usage.used / usage.total if usage.total else 0.0


def crawler_buckets(crawler_idx: int, num_crawlers: int) -> list[str]:
    """Partition the 16 top-level hex buckets across crawlers."""
    return [h for i, h in enumerate(_HEX) if i % num_crawlers == crawler_idx]


def crawl_candidates(
    store_root: str,
    buckets: Sequence[str],
    min_idle_seconds: float,
    now: Optional[float] = None,
    max_candidates: Optional[int] = None,
) -> Iterator[tuple[float, str]]:
    """Yield ``(atime, path)`` of deletable files in the crawler's buckets,
    oldest first.

    Deletable = block files (``*.bin``) idle for at least
    ``min_idle_seconds``, plus orphaned atomic-write temp files
    (``*.tmp.*`` from crashed writers) past the same idle window — those
    would otherwise leak disk forever since no reader ever touches them.

    ``max_candidates`` bounds memory with a heap (O(N log K) instead of a
    full sort): each pass only deletes a few batches, so collecting every
    candidate on a multi-million-file store would hammer metadata for
    nothing.
    """
    now = now if now is not None else time.time()
    candidates: list[tuple[float, str]] = []
    try:
        model_dirs = [
            os.path.join(store_root, d)
            for d in os.listdir(store_root)
            if os.path.isdir(os.path.join(store_root, d))
        ]
    except FileNotFoundError:
        return

    def scan() -> Iterator[tuple[float, str]]:
        for model_dir in model_dirs:
            for bucket in buckets:
                # top-level bucket dirs are 3 hex chars; partition by char 0
                try:
                    tops = [
                        t for t in os.listdir(model_dir)
                        if len(t) == 3 and t[0] == bucket
                    ]
                except FileNotFoundError:
                    continue
                for top in tops:
                    top_path = os.path.join(model_dir, top)
                    for dirpath, _dirs, files in os.walk(top_path):
                        for name in files:
                            # Live blocks, orphaned tmp files from crashed
                            # writers, and checksum-quarantined files (held
                            # briefly for post-mortem, reclaimed by the same
                            # age sweep) are all evictable.
                            if not (name.endswith(".bin") or ".tmp." in name
                                    or name.endswith(".quarantine")):
                                continue
                            path = os.path.join(dirpath, name)
                            try:
                                atime = os.stat(path).st_atime
                            except FileNotFoundError:
                                continue
                            if now - atime < min_idle_seconds:
                                continue
                            yield (atime, path)

    if max_candidates is not None:
        candidates = heapq.nsmallest(max_candidates, scan())
    else:
        candidates = sorted(scan())
    yield from candidates


def delete_batch(
    paths: Sequence[str],
    publish: Optional[Callable[[list[int]], None]] = None,
) -> int:
    """Delete files and publish BlockRemoved for the parsed hashes.

    Returns the number of files actually deleted.
    """
    deleted = 0
    hashes: list[int] = []
    for path in paths:
        try:
            os.unlink(path)
            deleted += 1
        except FileNotFoundError:
            continue
        parsed = FileMapper.parse_block_path(path)
        if parsed is not None:
            hashes.append(parsed[0])
    if publish is not None and hashes:
        publish(hashes)
    return deleted


def clean_empty_dirs(store_root: str, ttl_seconds: float,
                     now: Optional[float] = None) -> int:
    """Remove empty bucket dirs whose mtime is older than the TTL.

    The TTL guards against deleting a directory a writer just created but
    hasn't populated yet (reference ``folder_cleaner.py``).
    """
    now = now if now is not None else time.time()
    removed = 0
    for dirpath, dirs, files in os.walk(store_root, topdown=False):
        if dirpath == store_root or files or dirs:
            continue
        try:
            if now - os.stat(dirpath).st_mtime < ttl_seconds:
                continue
            os.rmdir(dirpath)
            removed += 1
        except OSError:
            continue
    return removed


class Evictor:
    """Supervised evictor pipeline."""

    def __init__(
        self,
        cfg: EvictorConfig,
        publisher: Optional[StorageEventPublisher] = None,
        usage_fn: Optional[Callable[[], float]] = None,
    ):
        self.cfg = cfg
        self._usage_fn = usage_fn or (lambda: disk_usage_fraction(cfg.store_root))
        self._publisher = publisher
        if publisher is None and cfg.storage_events_endpoint:
            self._publisher = StorageEventPublisher(
                cfg.storage_events_endpoint, cfg.model_name, bind=False
            )
        self.deletion_active = threading.Event()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self.total_deleted = 0
        self._deleted_lock = new_lock()

    # -- single-pass stages (deterministic, used by tests and the loops) --

    def activator_pass(self) -> bool:
        """Update the deletion flag from disk usage; returns the flag."""
        usage = self._usage_fn()
        if usage >= self.cfg.cleanup_threshold:
            if not self.deletion_active.is_set():
                logger.info("disk usage %.1f%% >= %.1f%%: deletion ON",
                            100 * usage, 100 * self.cfg.cleanup_threshold)
            self.deletion_active.set()
        elif usage <= self.cfg.target_threshold:
            if self.deletion_active.is_set():
                logger.info("disk usage %.1f%% <= %.1f%%: deletion OFF",
                            100 * usage, 100 * self.cfg.target_threshold)
            self.deletion_active.clear()
        return self.deletion_active.is_set()

    def crawl_and_delete_pass(self, crawler_idx: int = 0,
                              max_batches: int = 1) -> int:
        """One crawler pass: delete up to ``max_batches`` batches of the
        oldest idle files in this crawler's buckets. Stops early when the
        activator turns deletion off. Returns files deleted."""
        if not self.deletion_active.is_set():
            return 0
        buckets = crawler_buckets(crawler_idx, self.cfg.num_crawlers)
        publish = (
            self._publisher.publish_block_removed if self._publisher else None
        )
        deleted = 0
        batch: list[str] = []
        batches_done = 0
        for _atime, path in crawl_candidates(
            self.cfg.store_root, buckets, self.cfg.min_idle_seconds,
            max_candidates=self.cfg.delete_batch_size * max_batches,
        ):
            if not self.deletion_active.is_set():
                break
            batch.append(path)
            if len(batch) >= self.cfg.delete_batch_size:
                deleted += delete_batch(batch, publish)
                batch = []
                batches_done += 1
                self.activator_pass()  # re-check usage between batches
                if batches_done >= max_batches:
                    break
        if batch and self.deletion_active.is_set():
            deleted += delete_batch(batch, publish)
        with self._deleted_lock:
            self.total_deleted += deleted
        return deleted

    def folder_cleaner_pass(self) -> int:
        return clean_empty_dirs(self.cfg.store_root, self.cfg.empty_dir_ttl_s)

    # -- supervised loops --

    def start(self) -> None:
        """Start the supervised worker threads (idempotent)."""
        if self._threads:
            return
        self._stop.clear()

        def supervise(name: str, loop_fn: Callable[[], None]):
            def run():
                while not self._stop.is_set():
                    try:
                        loop_fn()
                    except Exception:
                        logger.exception("%s crashed; restarting", name)
                        self._stop.wait(1.0)
            t = threading.Thread(target=run, name=f"evictor-{name}", daemon=True)
            t.start()
            self._threads.append(t)

        def activator_loop():
            self.activator_pass()
            self._stop.wait(self.cfg.poll_interval_s)

        def make_crawler_loop(idx: int):
            def crawler_loop():
                if self.deletion_active.is_set():
                    self.crawl_and_delete_pass(idx, max_batches=4)
                self._stop.wait(self.cfg.poll_interval_s)
            return crawler_loop

        def cleaner_loop():
            self.folder_cleaner_pass()
            self._stop.wait(max(self.cfg.poll_interval_s * 6, 30.0))

        supervise("activator", activator_loop)
        for i in range(self.cfg.num_crawlers):
            supervise(f"crawler-{i}", make_crawler_loop(i))
        supervise("folder-cleaner", cleaner_loop)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads.clear()
