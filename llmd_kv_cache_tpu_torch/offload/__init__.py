"""KV offload data plane: device pools ↔ shared storage.

Port of ``llmd_kv_cache_tpu/offload/``, the counterpart of the reference's
``kv_connectors/llmd_fs_backend``: moves paged KV blocks between the card's
pools and a content-addressed file store whose bytes, paths and
fingerprints are the JAX package's. The device ↔ host leg runs on a side
stream through pinned host memory (``cuda_copier``, ``staging``); file I/O
runs on the native C++ thread pool (``csrc/kvio``, built by ``native``).
``handoff`` coordinates the prefill/decode handoff over this tier. Both
backends route per-group copiers: a hybrid engine binds its SWA pool as
group 1.

Not ported yet: the vLLM spec (``vllm_spec``) and the S3 clients of
``object_store``.
"""

from .file_mapper import FileMapper, FileMapperConfig
from .handoff import HandoffCoordinator, HandoffState
from .manager import SharedStorageOffloadManager
from .spec import SharedStorageOffloadSpec
from .worker import OffloadHandlers, TransferResult

__all__ = [
    "FileMapper",
    "FileMapperConfig",
    "HandoffCoordinator",
    "HandoffState",
    "SharedStorageOffloadManager",
    "SharedStorageOffloadSpec",
    "OffloadHandlers",
    "TransferResult",
]
