"""Protobuf stubs built at first use.

The generated ``*_pb2`` modules of ``indexerpb`` and ``tokenizerpb`` hold
protoc's serialized file descriptor and build their descriptors and
message classes on first attribute access (a module ``__getattr__``), not
at import: importing them then needs no ``google.protobuf``, which the
card's machine does not have. Only the protobuf surfaces (the ``indexer.v1``
wire of the indexer service, the ``tokenization`` wire of the tokenizer
sidecar) touch them, on the CPU.
"""

from __future__ import annotations

from ..utils.lockdep import new_lock

_lock = new_lock()


def lazy_stub(namespace: dict, module_name: str, serialized: bytes):
    """The module ``__getattr__`` of a stub whose globals are ``namespace``:
    the first lookup adds ``serialized`` to the default descriptor pool
    (an identical file already there, such as the JAX package's copy, is
    taken as is) and builds the messages into ``namespace``, as protoc's
    generated code does at import."""

    def __getattr__(name: str):
        if name.startswith("__"):
            raise AttributeError(name)
        with _lock:
            if "DESCRIPTOR" not in namespace:
                from google.protobuf import descriptor_pool
                from google.protobuf.internal import builder

                built: dict = {}
                descriptor = descriptor_pool.Default().AddSerializedFile(serialized)
                builder.BuildMessageAndEnumDescriptors(descriptor, built)
                builder.BuildTopDescriptorsAndMessages(descriptor, module_name, built)
                built["DESCRIPTOR"] = descriptor
                namespace.update(built)
        try:
            return namespace[name]
        except KeyError:
            raise AttributeError(
                f"module {namespace['__name__']!r} has no attribute {name!r}") from None

    return __getattr__
