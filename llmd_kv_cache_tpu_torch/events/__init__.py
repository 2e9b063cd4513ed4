"""KV events and their synchronous ingestion into the index."""
