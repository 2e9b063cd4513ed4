"""KV-block index: the in-memory backend behind the indexer."""
