"""Posit numerics configuration and the model ops whose divisions run on
the SRT datapath."""

from .formats import NUMERIC_FORMATS, NumericsConfig, resolve_format
from .posit_ops import posit_div_values, posit_rmsnorm_div
