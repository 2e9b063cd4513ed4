"""Protobuf wire surface (port of ``llmd_kv_cache_tpu/services/tokenizerpb``).

``tokenizer_pb2`` holds protoc's output for
``api/tokenizerpb/tokenizer.proto``, carried verbatim from the reference
(``api/tokenizerpb/tokenizer.proto:188-210``): the Go EPP's UDS tokenization
client is generated from this exact file, so interop requires a
byte-identical descriptor. Its messages are built at first use, so
importing the package needs no ``google.protobuf``.
"""

from . import tokenizer_pb2

__all__ = ["tokenizer_pb2"]
