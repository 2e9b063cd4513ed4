"""Device ↔ host transfers of paged KV blocks on a CUDA card.

Counterpart of ``llmd_kv_cache_tpu/offload/tpu_copier.py`` (``TPUBlockCopier``)
and of the reference's ``TensorCopier`` (``tensor_copier.cu:222-249``), with
the same duck-typed surface that the worker and the object store call. The
TPU copier moves pages with XLA gather and scatter, not with Pallas, so this
one moves them with ``index_select`` and in-place ``index_copy_``: no kernel
of this package's own.

Slab layout of an offloaded block (the JAX package's, so files are
byte-identical): ``[layers, streams, pages, kv_heads, page_size, head_dim]``
with streams 2 (K, V), or 1 for an MLA pool, whose V pool has width 0.

The copier holds the engine's own ``k_cache``/``v_cache`` and scatters into
them in place: the pools are never rebound, so a captured decode-burst graph
and the kernels' page tables keep addressing them. Bytes move as raw machine
words (``dtype`` is the numpy word type, ``uint16`` for bf16), because numpy
has no bf16 where ``ml_dtypes`` is absent; torch reinterprets them with
``Tensor.view``. An fp8 (e4m3) pool moves 1-byte words (``uint8``).

On the card, every transfer runs on the copier's side stream, ordered
against the engine's current stream both ways:

- gather: the side stream first waits on the current stream (the prefill
  kernel that wrote the pages may still be running: the reference's "wait
  for default stream", ``storage_offload.cpp:267-327``), gathers, and copies
  device → pinned host; that copy's event is synchronised before any byte
  is handed to kvio, whose threads read the buffer;
- scatter: host slabs must be pinned (the staging pool's slots); the side
  stream waits on the current stream, copies host → device and scatters,
  and the current stream waits on the scatter's event, so the next forward
  reads the restored pages. The host waits only for the copy, after which
  the staging slots may be recycled.

Nothing falls back: an unpinned host slab raises on the card, and pools on
the card have no CPU path. Pools on the CPU (the tests) take the same code
without streams or pinning.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from .staging import host_buffer

# torch dtype of the same width as the numpy word type a slab is moved in.
_TORCH_WORD = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
_NUMPY_WORD = {1: np.uint8, 2: np.uint16, 4: np.uint32}
_NUMPY_SIGNED = {1: np.uint8, 2: np.int16, 4: np.int32}


class CUDABlockCopier:
    """Moves groups of KV pages between the device pools and host slabs."""

    # Cap on pages merged into one device transfer: bounds the transient
    # device slab (offload runs exactly when device memory is tight).
    MAX_BATCH_PAGES = 128

    def __init__(self, k_cache: torch.Tensor, v_cache: torch.Tensor):
        self.k_cache = k_cache
        self.v_cache = v_cache
        layers, _, kv_heads, page_size, head_dim = k_cache.shape
        self.streams = 1 if v_cache.shape[-1] == 0 else 2
        self.slab_shape = lambda n: (layers, self.streams, n, kv_heads,
                                     page_size, head_dim)
        self.device = k_cache.device
        self.torch_dtype = k_cache.dtype
        itemsize = k_cache.element_size()
        if itemsize not in _NUMPY_WORD:
            raise NotImplementedError(f"no word type for {self.torch_dtype}")
        self.dtype = np.dtype(_NUMPY_WORD[itemsize])
        self._itemsize = itemsize
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)

    @property
    def pinned_host_active(self) -> bool:
        """True when the host legs run through page-locked memory (always on
        the card, where it is required; never for CPU pools)."""
        return self._side is not None

    def slab_nbytes(self, n_pages: int) -> int:
        return int(np.prod(self.slab_shape(n_pages))) * self._itemsize

    def _pools(self) -> list[torch.Tensor]:
        return [self.k_cache, self.v_cache][: self.streams]

    def _ids(self, page_ids: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(np.asarray(page_ids, np.int64), device=self.device)

    # -- gather (store) --

    def gather_to_host(self, page_ids: list[int]) -> np.ndarray:
        """One group's pages as a host slab."""
        return self.gather_many_to_host([list(page_ids)])[0]

    def gather_many_to_host(
        self, page_id_groups: list[list[int]]
    ) -> list[np.ndarray]:
        """Gather several page groups with few device programs and copies.

        Groups merge into transfers of at most ``MAX_BATCH_PAGES`` pages.
        Returns one contiguous host slab per group (of the word type,
        ``slab_shape(len(group))``), independent of the pools: views into
        the pinned buffer of its transfer on the card, which they keep
        alive."""
        out: list[np.ndarray] = []
        for chunk in _batches(page_id_groups, len, self.MAX_BATCH_PAGES):
            out.extend(self._gather_chunk(chunk))
        return out

    def _gather_rows(self, chunk: list[list[int]]) -> torch.Tensor:
        """The chunk's pages gathered group-major: one flat row of
        ``kv_heads * page_size * head_dim`` words for each (group, layer,
        stream, page), so each group's slab is one contiguous run."""
        n = sum(len(g) for g in chunk)
        ids = self._ids([p for g in chunk for p in g])
        merged = torch.stack([pool.index_select(1, ids) for pool in self._pools()],
                             dim=1)  # [layers, streams, n, kvh, page, hd]
        rows = merged.shape[0] * merged.shape[1]
        by_row = np.arange(rows)[:, None] * n
        order, start = [], 0
        for g in chunk:
            order.append((by_row + start + np.arange(len(g))).ravel())
            start += len(g)
        flat = merged.reshape(rows * n, -1)
        return flat.index_select(0, self._ids(np.concatenate(order)))

    def _gather_chunk(self, chunk: list[list[int]]) -> list[np.ndarray]:
        if self._side is None:
            words = self._gather_rows(chunk).view(_TORCH_WORD[self._itemsize])
            host = words.numpy().view(self.dtype).reshape(-1)
        else:
            current = torch.cuda.current_stream(self.device)
            self._side.wait_stream(current)
            with torch.cuda.stream(self._side):
                rows = self._gather_rows(chunk)
                pinned, host_bytes = host_buffer(rows.numel() * self._itemsize,
                                                 pinned=True)
                if not pinned.is_pinned():
                    raise RuntimeError("gather buffer is not page-locked")
                pinned.view(self.torch_dtype).copy_(rows.reshape(-1),
                                                    non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(self._side)
            # kvio's threads read the buffer: the copy must have landed.
            copied.synchronize()
            host = host_bytes.view(self.dtype)
        slabs, pos = [], 0
        for g in chunk:
            count = int(np.prod(self.slab_shape(len(g))))
            slabs.append(host[pos:pos + count].reshape(self.slab_shape(len(g))))
            pos += count
        return slabs

    # -- scatter (restore) --

    def scatter_from_host(self, slab: np.ndarray, page_ids: list[int]) -> None:
        """One host slab into the pools."""
        self.scatter_many_from_host([(slab, page_ids)])

    def scatter_many_from_host(
        self, slabs: list[tuple[np.ndarray, list[int]]]
    ) -> None:
        """Scatter several host slabs (any numpy type whose bytes are the
        slab's) with few device programs; merged transfers are capped at
        ``MAX_BATCH_PAGES`` pages."""
        for chunk in _batches(slabs, lambda s: len(s[1]), self.MAX_BATCH_PAGES):
            self._scatter_chunk(chunk)

    def _host_tensor(self, slab: np.ndarray, n_pages: int) -> torch.Tensor:
        """A torch view of a host slab's bytes (no copy), in the pool dtype."""
        words = (np.ascontiguousarray(slab).reshape(-1).view(np.uint8)
                 .view(_NUMPY_SIGNED[self._itemsize]).reshape(self.slab_shape(n_pages)))
        return torch.from_numpy(words).view(self.torch_dtype)

    def _scatter(self, merged: torch.Tensor, page_ids: list[int]) -> None:
        ids = self._ids(page_ids)
        # As raw words: index_copy_ has no fp8 kernel (CPU or CUDA).
        word = _TORCH_WORD[self._itemsize]
        for s, pool in enumerate(self._pools()):
            pool.view(word).index_copy_(1, ids, merged[:, s].view(word))

    def _scatter_chunk(self, chunk: list[tuple[np.ndarray, list[int]]]) -> None:
        parts = [self._host_tensor(slab, len(ids)) for slab, ids in chunk]
        page_ids = [p for _, ids in chunk for p in ids]
        if self._side is None:
            self._scatter(torch.cat(parts, dim=2), page_ids)
            return
        if not all(t.is_pinned() for t in parts):
            raise RuntimeError(
                "host slab is not page-locked: restores read the pinned "
                "staging pool's slots")
        current = torch.cuda.current_stream(self.device)
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            on_device = [t.to(self.device, non_blocking=True) for t in parts]
            copied = torch.cuda.Event()
            copied.record(self._side)
            self._scatter(torch.cat(on_device, dim=2), page_ids)
            scattered = torch.cuda.Event()
            scattered.record(self._side)
        current.wait_event(scattered)
        # The staging slots are recycled once this returns.
        copied.synchronize()


def _batches(items: Iterable, pages: Callable, cap: int) -> Iterable[list]:
    """Consecutive items merged while their pages fit ``cap`` (an item
    larger than the cap goes alone)."""
    chunk, n = [], 0
    for item in items:
        k = pages(item)
        if chunk and n + k > cap:
            yield chunk
            chunk, n = [], 0
        chunk.append(item)
        n += k
    if chunk:
        yield chunk
