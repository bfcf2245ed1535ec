"""Serialization compatible with the reference's on-disk formats."""
