"""Model configuration, dense layers and the dense transformer."""
