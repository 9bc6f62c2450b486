"""Geometry helpers (torch tensors; icosphere poses as numpy)."""
