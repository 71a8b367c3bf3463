"""Exact top-k feature retrieval."""
