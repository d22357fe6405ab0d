"""Paged KV cache, sampling, ragged metadata and the serving engine."""
