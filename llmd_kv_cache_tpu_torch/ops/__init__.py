"""Paged-KV ops: page scatter/gather, plain paged attention, Hopper kernels."""
