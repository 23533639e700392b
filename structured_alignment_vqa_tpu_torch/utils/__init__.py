"""Utilities: metrics, logging, checkpointing."""
