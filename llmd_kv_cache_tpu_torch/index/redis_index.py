"""Redis/Valkey index backend.

Copy of ``llmd_kv_cache_tpu/index/redis_index.py`` (counterpart of
reference ``pkg/kvcache/kvblock/redis.go``), sharing its data layout so
deployments can migrate between the Go indexer and this one without a
flush:

- request key ``<hash>``: a Redis hash whose *field names* are JSON-encoded
  pod entries (values unused) — lookup is a single pipelined ``HKEYS`` per
  key (one RTT for the whole prefix chain, ``redis.go:190-199``)
- engine key ``engine:<hash>``: a sorted set of request-key strings scored
  by chain index; ``get_request_key`` returns the highest-scored member

The client is injectable for tests (the reference uses miniredis; we use an
in-process fake implementing the handful of commands exercised). The real
client requires the optional ``redis`` package, imported in the
constructor only when no client is passed (never at import).

Valkey is wire-compatible; ``backend_type="valkey"`` only changes address
defaulting (RDMA transport is a server-side concern, ``redis.go:98-107``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional, Sequence

from ..core.keys import BlockHash, KeyType, PodEntry
from ..resilience.failpoints import failpoints
from ..utils.logging import get_logger
from .base import Index, infer_engine_mappings

logger = get_logger("index.redis")

# Failpoint guarding every Redis round-trip; armed by chaos tests to
# simulate a down/flapping server (see docs/resilience.md).
FP_REDIS_OP = "index.redis.op"


@dataclass
class RedisIndexConfig:
    address: str = "redis://127.0.0.1:6379"
    backend_type: str = "redis"  # or "valkey"
    enable_rdma: bool = False

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "RedisIndexConfig":
        if not d:
            return cls()
        return cls(
            address=d.get("address", "redis://127.0.0.1:6379"),
            backend_type=d.get("backendType", d.get("backend_type", "redis")),
            enable_rdma=d.get("enableRDMA", d.get("enable_rdma", False)),
        )


def _encode_pod_field(entry: PodEntry) -> str:
    # Stable JSON field encoding; key order fixed for field equality.
    return json.dumps(
        {
            "PodIdentifier": entry.pod_identifier,
            "DeviceTier": entry.device_tier,
            "Speculative": entry.speculative,
            "HasGroup": entry.has_group,
            "GroupIdx": entry.group_idx,
        },
        separators=(",", ":"),
    )


def _decode_pod_field(field: str | bytes) -> Optional[PodEntry]:
    if isinstance(field, bytes):
        field = field.decode("utf-8")
    try:
        d = json.loads(field)
        return PodEntry(
            pod_identifier=d["PodIdentifier"],
            device_tier=d["DeviceTier"],
            speculative=d.get("Speculative", False),
            has_group=d.get("HasGroup", False),
            group_idx=d.get("GroupIdx", 0),
        )
    except (json.JSONDecodeError, KeyError, TypeError):
        return None


def _engine_redis_key(engine_key: BlockHash) -> str:
    return f"engine:{engine_key}"


# Atomic prunes, mirroring the reference's server-side scripts
# (``redis.go:148-169``): deleting an empty hash / an engine mapping whose
# request hashes are all empty must be atomic with the emptiness check, or
# a concurrent Add between check and delete loses its entry.
PRUNE_REQUEST_KEY_SCRIPT = """
if redis.call('HLEN', KEYS[1]) == 0 then
  redis.call('DEL', KEYS[1])
  return 1
end
return 0
"""

PRUNE_ENGINE_KEY_SCRIPT = """
local rks = redis.call('ZRANGE', KEYS[1], 0, -1)
for i = 1, #rks do
  if redis.call('HLEN', rks[i]) > 0 then
    return 0
  end
end
redis.call('DEL', KEYS[1])
return 1
"""


class RedisIndex(Index):
    """Redis/Valkey-backed index."""

    def __init__(
        self,
        cfg: Optional[RedisIndexConfig | dict] = None,
        client=None,
    ):
        if isinstance(cfg, dict):
            cfg = RedisIndexConfig.from_dict(cfg)
        cfg = cfg or RedisIndexConfig()
        self._cfg = cfg
        if client is not None:
            self._client = client
        else:
            try:
                import redis as _redis  # optional dependency
            except ImportError as e:  # pragma: no cover
                raise RuntimeError(
                    "RedisIndex requires the 'redis' package (not installed); "
                    "pass an explicit client or use another backend"
                ) from e
            address = cfg.address
            if address.startswith("valkey://"):
                address = "redis://" + address[len("valkey://"):]
            elif "://" not in address:
                address = "redis://" + address
            self._client = _redis.Redis.from_url(address)
        # Atomic prunes need server-side scripting (registered once,
        # EVALSHA per call when the client supports it); clients without
        # scripting degrade to check-then-delete — a racing Add re-creates
        # state on the next event, which the soft-state model tolerates.
        self._prune_req = self._make_script(PRUNE_REQUEST_KEY_SCRIPT)
        self._prune_eng = self._make_script(PRUNE_ENGINE_KEY_SCRIPT)
        self._scripting = self._prune_req is not None

    def _make_script(self, text: str):
        reg = getattr(self._client, "register_script", None)
        if reg is not None:
            script = reg(text)
            return lambda keys: script(keys=keys)
        ev = getattr(self._client, "eval", None)
        if ev is not None:
            return lambda keys: ev(text, len(keys), *keys)
        return None

    def _prune_request_key(self, request_key: str) -> None:
        if self._scripting:
            self._prune_req([request_key])
        elif self._client.hlen(request_key) == 0:
            self._client.delete(request_key)

    def _prune_engine_key(self, engine_key: BlockHash,
                          rks: Sequence[str]) -> None:
        # The script re-reads the request-key set from the engine zset
        # server-side: a client-side snapshot would miss request keys a
        # concurrent Add registers between snapshot and delete.
        if self._scripting:
            self._prune_eng([_engine_redis_key(engine_key)])
        elif all(self._client.hlen(rk) == 0 for rk in rks):
            self._client.delete(_engine_redis_key(engine_key))

    def lookup(
        self,
        request_keys: Sequence[BlockHash],
        pod_identifier_set: Optional[set[str]] = None,
    ) -> dict[BlockHash, list[PodEntry]]:
        if not request_keys:
            raise ValueError("no request_keys provided for lookup")
        failpoints.hit(FP_REDIS_OP)

        pipe = self._client.pipeline()
        for key in request_keys:
            pipe.hkeys(str(key))
        results = pipe.execute()

        pods_per_key: dict[BlockHash, list[PodEntry]] = {}
        filter_pods = bool(pod_identifier_set)
        for key, fields in zip(request_keys, results):
            if not fields:
                # Redis cannot distinguish "absent" from "known but empty":
                # a missing hash has no fields either way, so any gap breaks
                # the chain (mirrors redis.go:216,231-232 early stops).
                return pods_per_key
            entries = [e for f in fields if (e := _decode_pod_field(f)) is not None]
            if filter_pods:
                entries = [e for e in entries if e.pod_identifier in pod_identifier_set]
            if entries:
                pods_per_key[key] = entries
        return pods_per_key

    def add(
        self,
        engine_keys: Optional[Sequence[BlockHash]],
        request_keys: Sequence[BlockHash],
        entries: Sequence[PodEntry],
    ) -> None:
        if not request_keys or not entries:
            raise ValueError("no keys or entries provided for adding to index")
        failpoints.hit(FP_REDIS_OP)

        pipe = self._client.pipeline()
        if engine_keys is not None:
            for ek, rks in infer_engine_mappings(engine_keys, request_keys).items():
                for i, rk in enumerate(rks):
                    pipe.zadd(_engine_redis_key(ek), {str(rk): float(i)})
        for rk in request_keys:
            for entry in entries:
                pipe.hset(str(rk), _encode_pod_field(entry), "")
        pipe.execute()

    def evict(
        self,
        key: BlockHash,
        key_type: KeyType,
        entries: Sequence[PodEntry],
    ) -> None:
        if not entries:
            raise ValueError("no entries provided for eviction from index")
        failpoints.hit(FP_REDIS_OP)

        if key_type is KeyType.ENGINE:
            rks = self._get_request_keys(key)
            if not rks:
                return
            for rk in rks:
                self._evict_pods_from_request_key(rk, entries)
            # Prune the engine mapping only if every mapped request hash is
            # empty — atomically (server-side script), so a concurrent Add
            # between the emptiness check and the delete cannot be lost.
            self._prune_engine_key(key, rks)
        elif key_type is KeyType.REQUEST:
            self._evict_pods_from_request_key(str(key), entries)
        else:  # pragma: no cover
            raise ValueError(f"unknown key type: {key_type}")

    def evict_batch(
        self,
        keys: Sequence[BlockHash],
        key_type: KeyType,
        entries: Sequence[PodEntry],
    ) -> None:
        """Evict many keys with pipelined round-trips.

        A BlockRemoved digest of N engine keys costs two pipelines (resolve
        + delete) instead of 2N sequential ones; end state is identical to
        looping ``evict`` (the prune scripts only check emptiness).
        """
        if not entries:
            raise ValueError("no entries provided for eviction from index")
        if not keys:
            return
        failpoints.hit(FP_REDIS_OP)
        fields = [_encode_pod_field(e) for e in entries]

        if key_type is KeyType.REQUEST:
            pipe = self._client.pipeline()
            for key in keys:
                for f in fields:
                    pipe.hdel(str(key), f)
            pipe.execute()
            for key in keys:
                self._prune_request_key(str(key))
            return
        if key_type is not KeyType.ENGINE:  # pragma: no cover
            raise ValueError(f"unknown key type: {key_type}")

        pipe = self._client.pipeline()
        for key in keys:
            pipe.zrange(_engine_redis_key(key), 0, -1)
        resolved = pipe.execute()

        per_key_rks: list[list[str]] = []
        pipe = self._client.pipeline()
        n_deletes = 0
        for vals in resolved:
            rks = [v.decode("utf-8") if isinstance(v, bytes) else v for v in vals]
            per_key_rks.append(rks)
            for rk in rks:
                for f in fields:
                    pipe.hdel(rk, f)
                    n_deletes += 1
        if n_deletes:
            pipe.execute()
        for key, rks in zip(keys, per_key_rks):
            if not rks:
                continue
            for rk in rks:
                self._prune_request_key(rk)
            self._prune_engine_key(key, rks)

    def _evict_pods_from_request_key(
        self, request_key: str, entries: Sequence[PodEntry]
    ) -> None:
        pipe = self._client.pipeline()
        for entry in entries:
            pipe.hdel(request_key, _encode_pod_field(entry))
        pipe.execute()
        self._prune_request_key(request_key)

    def _get_request_keys(self, engine_key: BlockHash) -> list[str]:
        vals = self._client.zrange(_engine_redis_key(engine_key), 0, -1)
        return [v.decode("utf-8") if isinstance(v, bytes) else v for v in vals]

    def get_request_key(self, engine_key: BlockHash) -> Optional[BlockHash]:
        failpoints.hit(FP_REDIS_OP)
        rks = self._get_request_keys(engine_key)
        if not rks:
            return None
        return int(rks[-1])

    def clear(self, pod_identifier: str) -> None:
        failpoints.hit(FP_REDIS_OP)
        # SCAN in batches; fields are JSON pod entries, so match by decoding
        # and comparing PodIdentifier — catches every tier/group/speculative
        # variant (redis.go:411-445).
        cursor = 0
        while True:
            cursor, keys = self._client.scan(cursor=cursor, count=512)
            for key in keys:
                key_str = key.decode("utf-8") if isinstance(key, bytes) else key
                if key_str.startswith("engine:"):
                    continue
                fields = self._client.hkeys(key_str)
                stale = [
                    f
                    for f in fields
                    if (e := _decode_pod_field(f)) is not None
                    and e.pod_identifier == pod_identifier
                ]
                if stale:
                    self._client.hdel(key_str, *stale)
                    self._prune_request_key(key_str)
            if cursor == 0:
                break
