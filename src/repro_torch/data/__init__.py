"""Deterministic synthetic LM data and a byte-level tokenizer."""

from .pipeline import DataConfig, SyntheticLMDataset
from .tokenizer import ByteTokenizer
