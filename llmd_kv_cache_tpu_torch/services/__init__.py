"""Sidecar services (port of ``llmd_kv_cache_tpu/services``): the indexer
service on its msgpack and protobuf gRPC wires, the stdlib admin and
metrics endpoints, and the tokenizer sidecar over gRPC-UDS.

``grpc`` and ``google.protobuf`` are imported where a server, a client or
a protobuf message is made, never at import; the card's path (scores over
the msgpack wire in-process, the admin server, ``SimpleTokenizer``) needs
neither. ``fleet_controller.py`` runs the fleet controller over the admin
planes' HTTP with ``urllib``; the telemetry collector
(``telemetry_collector.py``) waits for the fleet-telemetry planes (ROADMAP
A.8.6).
"""
