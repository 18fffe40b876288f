"""Single-device cube drivers."""
