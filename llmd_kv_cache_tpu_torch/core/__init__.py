"""Block-key core: content-addressed KV-block hashing and per-block metadata."""
