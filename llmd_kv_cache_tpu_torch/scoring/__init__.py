"""Pod scoring and the indexer orchestrator."""
