"""Synthetic token data with per-host sharding (counterpart of
``repro.data``)."""
from .pipeline import SyntheticTokens, shard_assignment

__all__ = ["SyntheticTokens", "shard_assignment"]
