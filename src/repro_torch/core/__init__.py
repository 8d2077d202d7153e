"""Posit codec, selection tables and the Table IV divider configurations."""
