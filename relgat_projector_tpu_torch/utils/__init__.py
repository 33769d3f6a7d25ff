"""Helpers: pytrees of tensors, random streams, seeding and logging."""
