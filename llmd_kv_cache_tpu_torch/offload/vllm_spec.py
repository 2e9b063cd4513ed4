"""vLLM ``OffloadingSpec`` shim: makes this repo's offload data plane
loadable by a vLLM pod on the card.

Port of ``llmd_kv_cache_tpu/offload/vllm_spec.py``, the counterpart of
reference ``llmd_fs_backend/spec.py:42-170`` (``SharedStorageOffloadingSpec``):
vLLM's ``OffloadingConnector`` loads the class named in
``kv_connector_extra_config`` and asks it for (a) the scheduler-side
``OffloadingManager`` and (b) the worker-side ``OffloadingHandler`` pairs.
This module adapts those contracts onto the port's pieces —
``SharedStorageOffloadSpec`` (fingerprinted layout),
``SharedStorageOffloadManager`` (stateless filesystem manager),
``OffloadHandlers`` (``CUDABlockCopier`` gather → native I/O pool) — so the
files a ``MiniEngine`` of either package writes are readable by a vLLM pod
and vice versa. The classes carry the card's name where JAX's carry the
TPU's: ``CUDASharedStorageLoadStoreSpec``, ``CUDAOffloadingManager``,
``CUDAStorageOffloadingSpec``.

Import-guarded: importing this module requires ``vllm`` (the real package
or a test double injected via ``sys.modules``, the reference's own CPU
test pattern — ``tests/cpu/test_storage_events.py:20-60``). Nothing else
in ``llmd_kv_cache_tpu_torch`` imports it.

vLLM job-id discipline (reference ``worker.py:326-405``): the caller
assigns ``job_id`` in ``transfer_async``; our native pool assigns its own.
The handler keeps the two-way mapping and translates on ``get_finished``.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

try:
    from vllm.v1.kv_offload.base import (  # type: ignore
        LoadStoreSpec,
        OffloadingManager,
        OffloadingSpec,
        PrepareStoreOutput,
    )
    from vllm.v1.kv_offload.worker.worker import (  # type: ignore
        OffloadingHandler,
        TransferResult,
    )
    import vllm.v1.kv_offload.base as _vllm_base  # type: ignore
except ImportError as e:
    raise ImportError(
        "llmd_kv_cache_tpu_torch.offload.vllm_spec requires vllm (or a test "
        "double registered in sys.modules before import); the rest of the "
        "offload package works without it"
    ) from e

from ..utils.logging import get_logger
from .cuda_copier import CUDABlockCopier
from .spec import SharedStorageOffloadSpec

logger = get_logger("offload.vllm_spec")

# GPULoadStoreSpec lives in base in current vLLM; fall back to a local
# marker class so the handler-pair tuple stays well-formed against older
# or stubbed layouts.
GPULoadStoreSpec = getattr(_vllm_base, "GPULoadStoreSpec", None)
if GPULoadStoreSpec is None:  # stub layouts only
    class GPULoadStoreSpec:  # type: ignore[no-redef]
        def __init__(self, block_ids):
            self.block_ids = list(block_ids)

# Optional key helpers (hybrid-model group routing). Identity fallbacks
# keep plain-int keys working against minimal stubs.
_block_hash = getattr(_vllm_base, "get_offload_block_hash", None) or (
    lambda key: key)
_group_idx = getattr(_vllm_base, "get_offload_group_idx", None) or (
    lambda key: 0)

DEFAULT_STORAGE_BLOCK_SIZE = 256  # tokens per offloaded file (ref spec.py:39)


class CUDASharedStorageLoadStoreSpec(LoadStoreSpec):
    """Storage-side transfer spec: the offload keys of one transfer.

    Reference ``mediums.py:SharedStorageLoadStoreSpec``."""

    def __init__(self, keys):
        self.keys = list(keys)

    def __repr__(self) -> str:
        return repr(self.keys)

    @staticmethod
    def medium() -> str:
        return "SHARED_STORAGE"


class CUDAOffloadingManager(OffloadingManager):
    """Scheduler-side adapter over ``SharedStorageOffloadManager``.

    Stateless like the reference (``manager.py``): lookup is file
    existence (touching atime for the evictor), stores are idempotent,
    eviction belongs to the storage-side evictor."""

    def __init__(self, inner):
        self.inner = inner

    def lookup(self, key, req_context=None):
        # Current vLLM contract (reference manager.py:100-105): single
        # key -> bool. Older generations passed an iterable of keys and
        # sliced by the returned hit-prefix length — accept both.
        if isinstance(key, (list, tuple)):
            counts = {}
            for k in key:
                g = _group_idx(k)
                if g not in counts:
                    counts[g] = self.inner.lookup(
                        [_block_hash(k2) for k2 in key
                         if _group_idx(k2) == g], g)
            return min(counts.values()) if counts else 0
        return self.inner.lookup([_block_hash(key)], _group_idx(key)) == 1

    def prepare_load(self, keys, req_context=None) -> LoadStoreSpec:
        return CUDASharedStorageLoadStoreSpec(keys)

    def touch(self, keys, req_context=None) -> None:
        # atime is touched by lookup's existence probe; nothing to do here
        # (reference manager.py "handled by the file thread").
        pass

    def complete_load(self, keys, req_context=None) -> None:
        self.inner.complete_load([_block_hash(k) for k in keys])

    def prepare_store(self, keys, req_context=None):
        # Shared storage always accepts; skip files already present
        # (stores are idempotent, the filter only saves device->host
        # traffic). PrepareStoreOutput carries the subset to write.
        # Freshness is per (group, hash): the same token block hashes
        # identically across a hybrid model's cache groups but lives in
        # per-group files.
        keys = list(keys)
        fresh: set[tuple[int, int]] = set()
        for g in {_group_idx(k) for k in keys}:
            fresh.update(
                (g, h) for h in self.inner.prepare_store(
                    [_block_hash(k) for k in keys if _group_idx(k) == g], g))
        to_store = [k for k in keys
                    if (_group_idx(k), _block_hash(k)) in fresh]
        return PrepareStoreOutput(
            keys_to_store=to_store,
            store_spec=CUDASharedStorageLoadStoreSpec(to_store),
            evicted_keys=[],
        )

    def complete_store(self, keys, req_context=None, success: bool = True):
        if success:
            self.inner.complete_store([_block_hash(k) for k in keys])

    def shutdown(self) -> None:
        publisher = getattr(self.inner, "event_publisher", None)
        if publisher is not None:
            publisher.close()


class _ResultMux:
    """Demultiplexes the shared engine's completions to the two direction
    handlers (store results to the store handler, loads to the load
    handler) — one ``OffloadHandlers`` engine serves both directions, so a
    poll from either side must not swallow the other side's results."""

    def __init__(self, handlers):
        self.handlers = handlers
        self._buffered: dict[bool, list] = {True: [], False: []}

    def drain(self, is_store: bool) -> list:
        for res in self.handlers.get_finished():
            self._buffered[res.is_store].append(res)
        out = self._buffered[is_store]
        self._buffered[is_store] = []
        return out


class _DirectionHandler(OffloadingHandler):
    """One transfer direction over the shared ``OffloadHandlers`` engine.

    Reference ``worker.py:326-405`` (GPUToStorageHandler /
    StorageToGPUHandler): ``transfer_async`` submits, ``get_finished``
    polls — with vLLM's caller-assigned job ids mapped onto the native
    pool's own ids."""

    def __init__(self, mux: _ResultMux, gpu_blocks_per_file: int,
                 is_store: bool, transfer_type):
        self.mux = mux
        self.handlers = mux.handlers
        self.gpu_blocks_per_file = gpu_blocks_per_file
        self.is_store = is_store
        self.transfer_type = transfer_type
        self._vllm_to_native: dict[int, int] = {}
        self._native_to_vllm: dict[int, int] = {}
        self._done: list = []  # translated results awaiting get_finished

    def _transfers(self, spec) -> list[tuple[int, list[int], int]]:
        """(block_hash, page_ids, group) triplets from a (src, dst) spec.

        The GPU side lists vLLM block ids (== this repo's page ids, one
        hash_block_size-token page each); the storage side lists offload
        keys, each covering ``gpu_blocks_per_file`` consecutive pages."""
        src, dst = spec
        gpu = src if self.is_store else dst
        storage = dst if self.is_store else src
        block_ids = [int(b) for b in gpu.block_ids]
        keys = storage.keys
        per = self.gpu_blocks_per_file
        if len(block_ids) != len(keys) * per:
            raise ValueError(
                f"transfer spec mismatch: {len(block_ids)} GPU blocks for "
                f"{len(keys)} offload keys x {per} blocks/file")
        return [
            (_block_hash(k), block_ids[i * per:(i + 1) * per], _group_idx(k))
            for i, k in enumerate(keys)
        ]

    def transfer_async(self, job_id: int, spec) -> bool:
        try:
            by_group: dict[int, list[tuple[int, list[int]]]] = {}
            for h, pages, g in self._transfers(spec):
                by_group.setdefault(g, []).append((h, pages))
            if len(by_group) != 1:
                # One native job per vLLM job keeps the id mapping 1:1;
                # multi-group transfers arrive as separate specs in vLLM
                # (per-group handlers), so this is a contract violation.
                raise ValueError(
                    f"transfer spans {len(by_group)} cache groups; expected 1")
            (group, transfers), = by_group.items()
            submit = (self.handlers.async_store_blocks if self.is_store
                      else self.handlers.async_load_blocks)
            native_id = submit(transfers, group_idx=group)
        except Exception:
            logger.exception("transfer_async failed (job_id=%d)", job_id)
            return False
        self._vllm_to_native[job_id] = native_id
        self._native_to_vllm[native_id] = job_id
        return True

    def _poll(self) -> None:
        """Translate newly-finished native results into ``_done``.

        Polling also applies load scatters (they run inside the engine's
        ``get_finished``), so ``wait`` must route through here rather than
        the engine's ``wait_job`` — that one is cancel-and-wait for
        preemption and would drop a completed load's H2D scatter."""
        for res in self.mux.drain(self.is_store):
            vllm_id = self._native_to_vllm.pop(res.job_id, None)
            if vllm_id is None:
                logger.warning("finished native job %d has no vLLM id",
                               res.job_id)
                continue
            self._vllm_to_native.pop(vllm_id, None)
            # A store whose writes were shed by the EMA queue limit did
            # not fully land; vLLM's binary result must not advertise it.
            success = res.success and not res.shed_hashes
            self._done.append(TransferResult(
                job_id=vllm_id,
                success=success,
                transfer_size=res.bytes_transferred,
                transfer_time=res.seconds,
                transfer_type=self.transfer_type,
            ))

    def get_finished(self) -> list:
        self._poll()
        out = self._done
        self._done = []
        return out

    def wait(self, job_ids, timeout_s: float = 60.0) -> None:
        """Block until the given vLLM jobs complete (reference
        ``worker.py:166-174``). Results stay queued for ``get_finished``."""
        import time as _time

        pending = {j for j in job_ids if j in self._vllm_to_native}
        deadline = _time.monotonic() + timeout_s
        while pending:
            self._poll()
            pending = {j for j in pending if j in self._vllm_to_native}
            if not pending:
                break
            if _time.monotonic() > deadline:
                raise TimeoutError(
                    f"transfers {sorted(pending)} still in flight after "
                    f"{timeout_s}s")
            _time.sleep(0.001)


class CUDAStorageOffloadingSpec(OffloadingSpec):
    """vLLM entry point: shared-storage offload for pods on the card.

    Reference ``spec.py:42-170``. Configure via
    ``kv_transfer_config.kv_connector_extra_config``:

    - ``shared_storage_path`` (default ``/tmp/shared-kv``)
    - ``block_size`` — tokens per offloaded file (default 256); must be a
      multiple of the GPU hash block size (this repo's page size)
    - ``threads_per_gpu``, ``read_preferring_ratio``,
      ``max_write_queued_seconds`` — native I/O pool knobs
    - geometry keys consumed by ``SharedStorageOffloadSpec.from_extra_config``
      (num_layers, kv_heads, head_dim, dtype, sliding_window, kv_streams, ...)
    """

    def __init__(self, vllm_config, kv_cache_config):
        try:
            super().__init__(vllm_config, kv_cache_config)
        except TypeError:  # minimal stubs whose base takes no args
            pass
        self.vllm_config = vllm_config
        self.kv_cache_config = kv_cache_config

        # The real base class supplies extra_config/hash_block_size; keep
        # working against stubs (and older vLLMs) by deriving them.
        if not hasattr(self, "extra_config"):
            ktc = getattr(vllm_config, "kv_transfer_config", None)
            self.extra_config = dict(
                getattr(ktc, "kv_connector_extra_config", None) or {})
        if not hasattr(self, "hash_block_size"):
            cache_cfg = getattr(vllm_config, "cache_config", None)
            self.hash_block_size = int(
                self.extra_config.get(
                    "page_size", getattr(cache_cfg, "block_size", 16)))

        self.offloaded_block_size = int(
            self.extra_config.get("block_size", DEFAULT_STORAGE_BLOCK_SIZE))
        if self.offloaded_block_size % self.hash_block_size != 0:
            raise ValueError(
                f"block_size ({self.offloaded_block_size}) must be a "
                f"multiple of the hash block size ({self.hash_block_size})")
        self.gpu_blocks_per_file = (
            self.offloaded_block_size // self.hash_block_size)
        # vLLM sizes its offload-key granularity from this factor.
        self.block_size_factor = self.gpu_blocks_per_file

        extra = dict(self.extra_config)
        extra.setdefault("root", extra.pop("shared_storage_path",
                                           "/tmp/shared-kv"))
        extra.setdefault("page_size", self.hash_block_size)
        extra.setdefault("io_threads",
                         int(extra.pop("threads_per_gpu", 16)))
        model_cfg = getattr(vllm_config, "model_config", None)
        if model_cfg is not None:
            extra.setdefault("model_name", getattr(model_cfg, "model",
                                                   "unknown"))
        extra["pages_per_block"] = self.gpu_blocks_per_file
        extra["blocks_per_file"] = 1  # one content-addressed file per key
        self.inner = SharedStorageOffloadSpec.from_extra_config(extra)

        self._manager: Optional[CUDAOffloadingManager] = None
        self._handlers = None

    # -- scheduler side --

    def get_manager(self) -> OffloadingManager:
        if self._manager is None:
            self._manager = CUDAOffloadingManager(self.inner.get_manager())
        return self._manager

    # -- worker side --

    def get_handlers(self, kv_caches) -> Iterator[tuple]:
        """Yield (src spec type, dst spec type, handler) per direction.

        ``kv_caches``: the worker's cache pools: a ``(k_cache, v_cache)``
        pair of the port's pools (CUDA tensors ``[layers, pages, kv_heads,
        page_size, head_dim]``; CPU tensors take the copier's plain path)
        or a sequence of such pairs (one per cache group, hybrid models).
        Groups after the first get ``CUDABlockCopier``s of their own."""
        if self._handlers is None:
            pairs = kv_caches
            if (isinstance(pairs, Sequence) and len(pairs) == 2
                    and not isinstance(pairs[0], Sequence)):
                pairs = [pairs]
            first_k, first_v = pairs[0]
            handlers = self.inner.get_handlers(first_k, first_v)
            for g, (k, v) in enumerate(pairs[1:], start=1):
                handlers.copiers[g] = CUDABlockCopier(k, v)
            self._handlers = handlers

            self._mux = _ResultMux(handlers)

        yield (
            GPULoadStoreSpec,
            CUDASharedStorageLoadStoreSpec,
            _DirectionHandler(self._mux, self.gpu_blocks_per_file,
                              is_store=True,
                              transfer_type=("gpu", "storage")),
        )
        yield (
            CUDASharedStorageLoadStoreSpec,
            GPULoadStoreSpec,
            _DirectionHandler(self._mux, self.gpu_blocks_per_file,
                              is_store=False,
                              transfer_type=("storage", "gpu")),
        )
