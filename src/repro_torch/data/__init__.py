"""Deterministic, resumable synthetic token pipeline (a copy of
``repro/data``: numpy only)."""

from .pipeline import DataCursor, TokenPipeline

__all__ = ["DataCursor", "TokenPipeline"]
