"""Crash-tolerant state (port of ``llmd_kv_cache_tpu/recovery``).

Ported: the pure digest helpers of ``reconcile.py`` that the indexer
service's ``GetPodDigest`` and ``GetPodBlocks`` answer with. Snapshots,
the journal, warm restart, drain and the anti-entropy loops wait for
ROADMAP A.8.6.
"""
