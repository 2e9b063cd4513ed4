"""Object-store offload backend.

Port of ``llmd_kv_cache_tpu/offload/object_store.py``: the directory-backed
client, the S3 client (``S3ObjectStoreClient`` over boto3, imported in its
transport's constructor, or the stdlib HTTP transport with SigV4 signing,
ranged GETs and paginated listing), the key mapper, the handlers and the
manager, writing the JAX package's object bytes. With
``transport="http"`` every failed request raises (``IOError`` with its
status): nothing falls back to a filesystem client. On the card, a loaded
object's payload is copied into a pinned staging slot before the copier's
H2D copy reads it (client libraries return pageable ``bytes``).

Counterpart of reference ``kv_connectors/llmd_fs_backend/llmd_nixl/``
(NIXL object-store engine + ObjBackend + NixlLookup): offload KV blocks to
an S3-style key/value store for cross-node sharing where no POSIX
filesystem spans the fleet (e.g. 70B multi-host offload,
``BASELINE.json.configs[4]``).

Pieces:

- ``ObjectStoreClient`` protocol — minimal S3-ish surface (put/get/exists/
  delete/list). ``FSObjectStoreClient`` backs it with a directory (tests,
  NFS); ``S3ObjectStoreClient`` with boto3 when available, else over HTTP;
  anything implementing the protocol plugs in.
- ``ObjectKeyMapper`` — same fingerprint discipline as the FileMapper, flat
  key namespace ``<prefix>/<fingerprint>/r<rank>/g<group>/<hash16>``.
- ``ObjectStoreOffloadHandlers`` — the same async job surface as the POSIX
  ``OffloadHandlers`` (store/load/get_finished/wait_job), with transfers on
  a Python thread pool (object I/O is client-library code, unlike the
  GIL-free POSIX path).
- ``ObjectStoreOffloadManager`` — lookup via ``exists``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from concurrent import futures
from dataclasses import dataclass, field
from typing import Optional, Protocol, Sequence

import numpy as np

from ..events.publisher import StorageEventPublisher
from ..utils.atomic_io import atomic_write_bytes
from .cuda_copier import CUDABlockCopier
from .staging import HostStagingPool, pool_size_for
from .worker import (FileSpan, TransferResult, assemble_file_buffers,
                     check_span, validate_store_coverage)

logger = logging.getLogger(__name__)


class ObjectStoreClient(Protocol):
    def put(self, key: str, data: bytes) -> None: ...

    def get(self, key: str) -> Optional[bytes]: ...

    def exists(self, key: str) -> bool: ...

    def delete(self, key: str) -> bool: ...

    def list_keys(self, prefix: str) -> list[str]: ...


def client_get_range(client: ObjectStoreClient, key: str, start: int,
                     length: int) -> Optional[bytes]:
    """Ranged read: ``client.get_range`` when the client offers it (S3
    Range GETs, seek+read on files), else a full ``get`` sliced host-side.
    The fallback costs the whole object's bytes over the wire but keeps
    every protocol-conforming client usable for multi-block span loads."""
    getter = getattr(client, "get_range", None)
    if getter is not None:
        return getter(key, start, length)
    data = client.get(key)
    if data is None:
        return None
    if start + length > len(data):
        return None  # short object: treat like a missing range
    return data[start:start + length]


class FSObjectStoreClient:
    """Directory-backed object store (tests / shared-FS deployments).

    Keys map to files under the root; puts are atomic (tmp+rename) so
    concurrent readers never see partial objects.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        safe = key.replace("/", os.sep)
        return os.path.join(self.root, safe)

    def put(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # Durable publish (atomic_io): fsync file + dir before/after the
        # rename so a crash can't surface a renamed-but-empty object.
        atomic_write_bytes(path, data)

    def get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def get_range(self, key: str, start: int, length: int) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                f.seek(start)
                data = f.read(length)
        except FileNotFoundError:
            return None
        return data if len(data) == length else None

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def delete(self, key: str) -> bool:
        try:
            os.unlink(self._path(key))
            return True
        except FileNotFoundError:
            return False

    def list_keys(self, prefix: str) -> list[str]:
        base = self._path(prefix)
        out = []
        for dirpath, _dirs, files in os.walk(base):
            for name in files:
                full = os.path.join(dirpath, name)
                rel = os.path.relpath(full, self.root)
                out.append(rel.replace(os.sep, "/"))
        return out


class _BotoS3:
    """boto3 transport (AWS-grade auth/retries when the package exists).
    ``boto3`` is imported here, in the constructor, so it stays off the
    import path (neither the CPU tests' host nor the card's has it)."""

    def __init__(self, bucket: str, endpoint_url: Optional[str],
                 access_key: Optional[str] = None,
                 secret_key: Optional[str] = None,
                 region: Optional[str] = None):
        import boto3

        kwargs: dict = {"endpoint_url": endpoint_url}
        if access_key and secret_key:
            kwargs.update(aws_access_key_id=access_key,
                          aws_secret_access_key=secret_key)
        if region:
            kwargs["region_name"] = region
        self._s3 = boto3.client("s3", **kwargs)
        self.bucket = bucket

    def put(self, key: str, data: bytes) -> None:
        self._s3.put_object(Bucket=self.bucket, Key=key, Body=data)

    def get(self, key: str) -> Optional[bytes]:
        try:
            return self._s3.get_object(Bucket=self.bucket, Key=key)["Body"].read()
        except self._s3.exceptions.NoSuchKey:
            return None

    def exists(self, key: str) -> bool:
        try:
            self._s3.head_object(Bucket=self.bucket, Key=key)
            return True
        except Exception:
            return False

    def get_range(self, key: str, start: int, length: int) -> Optional[bytes]:
        try:
            resp = self._s3.get_object(
                Bucket=self.bucket, Key=key,
                Range=f"bytes={start}-{start + length - 1}",
            )
            data = resp["Body"].read()
        except self._s3.exceptions.NoSuchKey:
            return None
        return data if len(data) == length else None

    def delete(self, key: str) -> bool:
        self._s3.delete_object(Bucket=self.bucket, Key=key)
        return True

    def list_keys(self, prefix: str) -> list[str]:
        out = []
        paginator = self._s3.get_paginator("list_objects_v2")
        for page in paginator.paginate(Bucket=self.bucket, Prefix=prefix):
            out.extend(obj["Key"] for obj in page.get("Contents", []))
        return out


class _HttpS3:
    """Stdlib S3 REST transport: path-style addressing against any
    S3-compatible endpoint (MinIO, Ceph RGW, in-cluster gateways), with
    optional AWS SigV4 signing when credentials are provided. Exists so
    the cross-node offload path works in hermetic environments without
    boto3 — the analog of the reference's NIXL OBJ plugin speaking the
    wire protocol directly."""

    def __init__(self, bucket: str, endpoint_url: str,
                 access_key: Optional[str] = None,
                 secret_key: Optional[str] = None,
                 region: str = "us-east-1", timeout_s: float = 30.0):
        self.bucket = bucket
        self.endpoint = endpoint_url.rstrip("/")
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.timeout_s = timeout_s

    # -- SigV4 (AWS auth sigv4-create-signed-request); skipped unsigned --

    def _sign(self, method: str, path: str, query: str,
              payload: bytes) -> dict:
        import datetime
        import hashlib
        import hmac
        from urllib.parse import urlparse

        if not (self.access_key and self.secret_key):
            return {}  # unsigned: no auth headers, no payload hashing
        host = urlparse(self.endpoint).netloc
        payload_hash = hashlib.sha256(payload).hexdigest()
        headers = {"host": host, "x-amz-content-sha256": payload_hash}
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        headers["x-amz-date"] = amz_date
        signed = ";".join(sorted(headers))
        canonical = "\n".join([
            method, path, query,
            "".join(f"{k}:{headers[k]}\n" for k in sorted(headers)),
            signed, payload_hash,
        ])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope,
            hashlib.sha256(canonical.encode()).hexdigest(),
        ])
        key = f"AWS4{self.secret_key}".encode()
        for part in (datestamp, self.region, "s3", "aws4_request"):
            key = hmac.new(key, part.encode(), hashlib.sha256).digest()
        sig = hmac.new(key, to_sign.encode(), hashlib.sha256).hexdigest()
        headers["Authorization"] = (
            f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
            f"SignedHeaders={signed}, Signature={sig}")
        return headers

    def _request(self, method: str, key: str = "", query: str = "",
                 data: bytes = b"", range_header: Optional[str] = None):
        import urllib.error
        import urllib.request
        from urllib.parse import quote, urlparse

        # The signed canonical URI is the full path the SERVER sees —
        # including any path component of the endpoint (reverse-proxied
        # gateways like http://host/minio).
        base = urlparse(self.endpoint).path.rstrip("/")
        path = (base + "/"
                + quote(f"{self.bucket}/{key}" if key else self.bucket))
        url = (self.endpoint[:len(self.endpoint) - len(base)] if base
               else self.endpoint) + path + (f"?{query}" if query else "")
        headers = self._sign(method, path, query, data)
        if range_header:
            headers["Range"] = range_header
        req = urllib.request.Request(url, data=data or None, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def put(self, key: str, data: bytes) -> None:
        status, body = self._request("PUT", key, data=data)
        if status not in (200, 201):
            raise IOError(f"S3 PUT {key} failed: HTTP {status}")

    def get(self, key: str) -> Optional[bytes]:
        status, body = self._request("GET", key)
        if status == 404:
            return None
        if status != 200:
            raise IOError(f"S3 GET {key} failed: HTTP {status}")
        return body

    def get_range(self, key: str, start: int, length: int) -> Optional[bytes]:
        status, body = self._request(
            "GET", key, range_header=f"bytes={start}-{start + length - 1}")
        if status == 404:
            return None
        if status not in (200, 206):
            raise IOError(f"S3 ranged GET {key} failed: HTTP {status}")
        if status == 200:  # endpoint ignored Range: slice host-side
            body = body[start:start + length]
        return body if len(body) == length else None

    def exists(self, key: str) -> bool:
        status, _ = self._request("HEAD", key)
        return status == 200

    def delete(self, key: str) -> bool:
        status, _ = self._request("DELETE", key)
        return status in (200, 204)

    def list_keys(self, prefix: str) -> list[str]:
        import xml.etree.ElementTree as ET
        from urllib.parse import quote

        out: list[str] = []
        token: Optional[str] = None
        while True:
            # Sorted params: SigV4 canonicalizes the query string.
            params = [("list-type", "2"), ("prefix", prefix)]
            if token:
                params.append(("continuation-token", token))
            query = "&".join(
                f"{k}={quote(v, safe='')}" for k, v in sorted(params))
            status, body = self._request("GET", "", query=query)
            if status != 200:
                raise IOError(f"S3 LIST {prefix} failed: HTTP {status}")
            root = ET.fromstring(body)
            ns = root.tag[:root.tag.index("}") + 1] if "}" in root.tag else ""
            out.extend(el.text for el in root.iter(f"{ns}Key"))
            token_el = root.find(f"{ns}NextContinuationToken")
            truncated = root.findtext(f"{ns}IsTruncated", "false")
            if truncated != "true" or token_el is None or not token_el.text:
                return out
            token = token_el.text


class S3ObjectStoreClient:
    """S3-compatible client: boto3 when importable, else the stdlib HTTP
    transport (``endpoint_url`` required in that case — path-style
    S3-compatible endpoints)."""

    def __init__(self, bucket: str, endpoint_url: Optional[str] = None,
                 access_key: Optional[str] = None,
                 secret_key: Optional[str] = None,
                 region: Optional[str] = None,
                 transport: Optional[str] = None):
        # Standard AWS env credentials work on BOTH transports (k8s pods
        # inject them as env vars; boto3 reads them natively, the HTTP
        # transport must read them here or auth silently differs by
        # which transport auto-detection picked).
        access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID")
        secret_key = secret_key or os.environ.get("AWS_SECRET_ACCESS_KEY")
        region = region or os.environ.get("AWS_DEFAULT_REGION") or "us-east-1"
        if transport is None:
            try:
                import boto3  # noqa: F401
                transport = "boto3"
            except ImportError:
                transport = "http"
        if transport not in ("boto3", "http"):
            raise ValueError(
                f"unknown transport {transport!r}; expected 'boto3' or "
                "'http'")
        if transport == "boto3":
            self._impl = _BotoS3(bucket, endpoint_url, access_key,
                                 secret_key, region)
        else:
            if not endpoint_url:
                raise ValueError(
                    "S3ObjectStoreClient without boto3 needs endpoint_url "
                    "(path-style S3-compatible endpoint)")
            self._impl = _HttpS3(bucket, endpoint_url, access_key,
                                 secret_key, region)
        self.bucket = bucket

    def put(self, key: str, data: bytes) -> None:
        self._impl.put(key, data)

    def get(self, key: str) -> Optional[bytes]:
        return self._impl.get(key)

    def get_range(self, key: str, start: int, length: int) -> Optional[bytes]:
        return self._impl.get_range(key, start, length)

    def exists(self, key: str) -> bool:
        return self._impl.exists(key)

    def delete(self, key: str) -> bool:
        return self._impl.delete(key)

    def list_keys(self, prefix: str) -> list[str]:
        return self._impl.list_keys(prefix)




@dataclass
class ObjectKeyMapper:
    """Fingerprinted flat key namespace for offloaded blocks."""

    prefix: str
    fingerprint: str
    rank: int = 0
    parallel_agnostic: bool = False

    def block_key(self, block_hash: int, group_idx: int = 0) -> str:
        h = block_hash & 0xFFFFFFFFFFFFFFFF
        rank_seg = "" if self.parallel_agnostic else f"/r{self.rank}"
        return f"{self.prefix}/{self.fingerprint}{rank_seg}/g{group_idx}/{h:016x}"

    @staticmethod
    def parse_block_key(key: str) -> Optional[int]:
        name = key.rsplit("/", 1)[-1]
        try:
            return int(name, 16)
        except ValueError:
            return None


@dataclass
class _ObjJob:
    job_id: int
    is_store: bool
    started: float
    futures: list = field(default_factory=list)
    # (future, page_ids, byte offset into payload, length|None=whole)
    scatters: list = field(default_factory=list)
    shed_hashes: list = field(default_factory=list)
    nbytes: int = 0
    cancelled: bool = False
    group_idx: int = 0  # cache group the job's pages belong to


class ObjectStoreOffloadHandlers:
    """Async store/load over an object store, same surface as the POSIX
    handlers (multi-block span objects with ranged loads)."""

    def __init__(
        self,
        copier: CUDABlockCopier,
        client: ObjectStoreClient,
        mapper: ObjectKeyMapper,
        io_threads: int = 4,
        max_queued_puts: Optional[int] = None,
        blocks_per_file: int = 1,
        pages_per_block: int = 1,
    ):
        self.copier = copier
        # Copiers by cache group: a hybrid engine binds group 1 (its SWA
        # pool) as copiers[1].
        self.copiers: dict[int, CUDABlockCopier] = {0: copier}
        # Pinned landing slots for loaded payloads on the card (one object
        # each).
        self.staging = HostStagingPool(
            slot_bytes=copier.slab_nbytes(pages_per_block) * blocks_per_file,
            slots=pool_size_for(io_threads), pinned=copier.pinned_host_active)
        self.client = client
        self.mapper = mapper
        self.blocks_per_file = blocks_per_file
        self.pages_per_block = pages_per_block
        self._executor = futures.ThreadPoolExecutor(
            max_workers=io_threads, thread_name_prefix="objstore-io"
        )
        self._jobs: dict[int, _ObjJob] = {}
        self._next_job = 1
        self._lock = threading.Lock()
        # Backpressure: each queued put pins a full host slab, so bound the
        # number in flight and shed the rest (the object-store analogue of
        # the POSIX engine's EMA write shedding — a future cache miss, not
        # unbounded host memory).
        self._put_slots = threading.Semaphore(
            max_queued_puts if max_queued_puts is not None else io_threads * 4
        )

    def _make_job(self, is_store: bool) -> _ObjJob:
        with self._lock:
            job_id = self._next_job
            self._next_job += 1
        return _ObjJob(job_id=job_id, is_store=is_store,
                       started=time.perf_counter())

    def _register(self, job: _ObjJob) -> int:
        # Register only after every future is attached: a concurrent
        # get_finished() poll must never observe a half-submitted job (an
        # empty futures list reads as "complete").
        with self._lock:
            self._jobs[job.job_id] = job
        return job.job_id

    def _put_released(self, fut) -> None:
        self._put_slots.release()

    def async_store_blocks(
        self, transfers: Sequence[tuple[int, Sequence[int]]], group_idx: int = 0
    ) -> int:
        job = self._make_job(is_store=True)
        job.group_idx = group_idx
        copier = self.copiers[group_idx]
        # Acquire put slots BEFORE gathering: a saturated store must shed
        # without paying device gathers/DMAs for data it will discard.
        admitted: list[tuple[int, list[int]]] = []
        for block_hash, page_ids in transfers:
            if self._put_slots.acquire(blocking=False):
                admitted.append((block_hash, list(page_ids)))
            else:
                job.shed_hashes.append(block_hash)
        slabs = copier.gather_many_to_host([p for _, p in admitted])
        for (block_hash, _page_ids), slab in zip(admitted, slabs):
            key = self.mapper.block_key(block_hash, group_idx)
            # Zero-copy byte view (bfloat16 etc. lack the buffer protocol,
            # so reinterpret as uint8 first).
            data = memoryview(np.ascontiguousarray(slab).view(np.uint8).reshape(-1))
            job.nbytes += len(data)
            fut = self._executor.submit(self.client.put, key, data)
            fut.add_done_callback(self._put_released)
            job.futures.append(fut)
        return self._register(job)

    def async_load_blocks(
        self, transfers: Sequence[tuple[int, Sequence[int]]], group_idx: int = 0
    ) -> int:
        job = self._make_job(is_store=False)
        job.group_idx = group_idx
        for block_hash, page_ids in transfers:
            key = self.mapper.block_key(block_hash, group_idx)
            fut = self._executor.submit(self.client.get, key)
            job.futures.append(fut)
            # (future, page_ids, byte offset into the payload, length|None
            # = whole payload) — same record shape as the span loads.
            job.scatters.append((fut, list(page_ids), 0, None))
        return self._register(job)

    # -- multi-block span objects (unaligned head/tail) --

    def _check_span(self, span: FileSpan) -> None:
        check_span(span, self.blocks_per_file, self.pages_per_block)

    def async_store_spans(self, spans: Sequence[FileSpan],
                          group_idx: int = 0) -> int:
        """Store multi-block spans as whole objects; returns the job id.

        Same durability rule as the POSIX engine: every touched object must
        be FULLY covered by the spans' union (lookup treats object
        existence as "stored", and object puts are atomic — a partially-
        provisioned object would serve holes as successful loads).
        """
        by_file = validate_store_coverage(spans, self.blocks_per_file,
                                          self.pages_per_block)

        job = self._make_job(is_store=True)
        job.group_idx = group_idx
        copier = self.copiers[group_idx]
        object_bytes = (copier.slab_nbytes(self.pages_per_block)
                        * self.blocks_per_file)
        admitted: list[FileSpan] = []
        # Shed whole objects (every span of the object together): a put
        # slot covers one assembled object buffer.
        for file_key, file_spans in by_file.items():
            if self._put_slots.acquire(blocking=False):
                admitted.extend(file_spans)
            else:
                job.shed_hashes.append(file_key)
        all_slabs = copier.gather_many_to_host(
            [list(b) for span in admitted for b in span.blocks]
        )
        for file_key, buf in assemble_file_buffers(
                admitted, all_slabs, object_bytes).items():
            key = self.mapper.block_key(file_key, group_idx)
            job.nbytes += buf.nbytes
            fut = self._executor.submit(self.client.put, key, memoryview(buf))
            fut.add_done_callback(self._put_released)
            job.futures.append(fut)
        return self._register(job)

    def async_load_spans(self, spans: Sequence[FileSpan],
                         group_idx: int = 0) -> int:
        """Load multi-block spans via ranged object reads (partial objects
        start at the span's head-offset byte); returns the job id."""
        for span in spans:
            self._check_span(span)
        job = self._make_job(is_store=False)
        job.group_idx = group_idx
        copier = self.copiers[group_idx]
        slot_bytes = copier.slab_nbytes(self.pages_per_block)
        for span in spans:
            key = self.mapper.block_key(span.file_key, group_idx)
            fut = self._executor.submit(
                client_get_range, self.client, key,
                span.head_offset * slot_bytes, len(span.blocks) * slot_bytes,
            )
            job.futures.append(fut)
            # One ranged read covers several block slots; split it into
            # per-block scatters at completion.
            for k, page_ids in enumerate(span.blocks):
                job.scatters.append(
                    (fut, list(page_ids), k * slot_bytes, slot_bytes))
        return self._register(job)

    def get_finished(self) -> list[TransferResult]:
        results = []
        with self._lock:
            done_ids = [
                jid for jid, job in self._jobs.items()
                if all(f.done() for f in job.futures)
            ]
            done_jobs = [self._jobs.pop(jid) for jid in done_ids]

        for job in done_jobs:
            copier = self.copiers[job.group_idx]
            success = not job.cancelled
            for f in job.futures:
                if f.cancelled() or f.exception() is not None:
                    success = False
                elif not job.is_store and f.result() is None:  # done() filtered above
                    success = False  # missing object / short range
            if success and not job.is_store:
                batch = []
                landed = []
                counted = set()
                for fut, page_ids, off, length in job.scatters:
                    data = fut.result()  # done() filtered above
                    if id(fut) not in counted:  # span loads share a future
                        counted.add(id(fut))
                        job.nbytes += len(data)
                    payload = data if length is None else data[off:off + length]
                    # Into a staging slot (pinned on the card), as words
                    # the copier reinterprets as the pool's dtype.
                    slot = self.staging.acquire(len(payload))
                    slot[:] = np.frombuffer(payload, dtype=np.uint8)
                    landed.append(slot)
                    batch.append((
                        np.frombuffer(slot, dtype=copier.dtype).reshape(
                            copier.slab_shape(len(page_ids))
                        ),
                        page_ids,
                    ))
                try:
                    copier.scatter_many_from_host(batch)
                finally:
                    for slot in landed:
                        self.staging.release(slot)
            results.append(
                TransferResult(
                    job_id=job.job_id,
                    success=success,
                    is_store=job.is_store,
                    bytes_transferred=job.nbytes if success else 0,
                    seconds=time.perf_counter() - job.started,
                    shed_hashes=job.shed_hashes,
                )
            )
        return results

    def wait_job(self, job_id: int, timeout_s: float = 30.0) -> int:
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                return 0
            job.cancelled = True
        for f in job.futures:
            f.cancel()
        deadline = time.monotonic() + timeout_s
        for f in job.futures:
            if f.cancelled():
                continue
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return -1
            try:
                f.exception(timeout=remaining)
            except futures.TimeoutError:
                return -1
            except Exception:  # failure reported via the job status
                pass
        with self._lock:
            self._jobs.pop(job_id, None)
        return 2  # cancelled

    def shutdown(self) -> None:
        self._executor.shutdown(wait=False, cancel_futures=True)


class ObjectStoreOffloadManager:
    """Scheduler-side manager over an object store."""

    def __init__(
        self,
        client: ObjectStoreClient,
        mapper: ObjectKeyMapper,
        event_publisher: Optional[StorageEventPublisher] = None,
        block_size_tokens: int = 16,
    ):
        self.client = client
        self.mapper = mapper
        self.event_publisher = event_publisher
        self.block_size_tokens = block_size_tokens
        # Optional working-set tap (telemetry.workingset), same contract
        # as SharedStorageOffloadManager.workingset.
        self.workingset = None

    def lookup(self, block_hashes: Sequence[int], group_idx: int = 0) -> int:
        hits = 0
        for h in block_hashes:
            if not self.client.exists(self.mapper.block_key(h, group_idx)):
                break
            hits += 1
        if self.workingset is not None and group_idx == 0:
            self.workingset.record_offload_read(block_hashes, hits=hits)
        return hits

    def prepare_store(self, block_hashes: Sequence[int], group_idx: int = 0) -> list[int]:
        return [
            h for h in block_hashes
            if not self.client.exists(self.mapper.block_key(h, group_idx))
        ]

    def complete_store(self, block_hashes: Sequence[int]) -> None:
        if self.workingset is not None and block_hashes:
            self.workingset.record_offload_write(block_hashes)
        if self.event_publisher is not None and block_hashes:
            self.event_publisher.publish_block_stored(
                list(block_hashes), self.block_size_tokens
            )

    def complete_load(self, block_hashes: Sequence[int]) -> None:
        pass
