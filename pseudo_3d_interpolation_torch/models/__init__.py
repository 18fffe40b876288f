"""POCS solver and its sparse transforms."""
