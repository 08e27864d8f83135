"""Paged KV storage of the port (layouts and pool operations)."""
