"""Helpers: pytrees of tensors and random streams."""
