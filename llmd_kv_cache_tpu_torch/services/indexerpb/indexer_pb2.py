"""Protocol buffer code for ``api/indexerpb/indexer.proto``.

``SERIALIZED_PB`` is protoc's serialized file descriptor (do not edit it),
byte for byte the one in
``llmd_kv_cache_tpu/services/indexerpb/indexer_pb2.py``. The descriptors and
message classes are built on first attribute access
(``services._protobuf.lazy_stub``), so this module imports without
``google.protobuf``.
"""

from .._protobuf import lazy_stub

SERIALIZED_PB = b'\n\rindexer.proto\x12\nindexer.v1\"R\n\x13GetPodScoresRequest\x12\x0e\n\x06prompt\x18\x01 \x01(\t\x12\x12\n\nmodel_name\x18\x02 \x01(\t\x12\x17\n\x0fpod_identifiers\x18\x03 \x03(\t\"<\n\x14GetPodScoresResponse\x12$\n\x06scores\x18\x01 \x03(\x0b\x32\x14.indexer.v1.PodScore\"&\n\x08PodScore\x12\x0b\n\x03pod\x18\x01 \x01(\t\x12\r\n\x05score\x18\x02 \x01(\x01\x32\x65\n\x0eIndexerService\x12S\n\x0cGetPodScores\x12\x1f.indexer.v1.GetPodScoresRequest\x1a .indexer.v1.GetPodScoresResponse\"\x00\x42\x39Z7github.com/llm-d/llm-d-kv-cache/api/indexerpb;indexerpbb\x06proto3'

__getattr__ = lazy_stub(globals(), 'indexer_pb2', SERIALIZED_PB)
