"""Datasets and loaders (Objaverse object-level, RE10K scene-level)."""
