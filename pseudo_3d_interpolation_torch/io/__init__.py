"""Host-side data containers (in-memory cube)."""
