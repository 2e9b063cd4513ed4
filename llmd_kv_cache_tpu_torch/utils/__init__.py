"""Shared utilities: canonical CBOR, FNV hashing, LRU cache."""
