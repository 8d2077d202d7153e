"""Deterministic synthetic LM data."""

from .pipeline import DataConfig, SyntheticLMDataset
