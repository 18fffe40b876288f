"""Host-side data: the in-memory cube and its netCDF files."""
