"""Parallel and training layers of the port (one device in this slice)."""
