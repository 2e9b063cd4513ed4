"""Protobuf wire surface (port of ``llmd_kv_cache_tpu/services/indexerpb``).

``indexer_pb2`` holds protoc's output for ``api/indexerpb/indexer.proto``,
carried verbatim from the reference (``api/indexerpb/indexer.proto:24-43``):
the Go EPP's client is generated from this exact file, so interop requires
a byte-identical descriptor. Its messages are built at first use, so
importing the package needs no ``google.protobuf``.
"""

from . import indexer_pb2

__all__ = ["indexer_pb2"]
