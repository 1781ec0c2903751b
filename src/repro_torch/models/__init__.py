"""Model layers and the transformer assembly (forward only)."""
