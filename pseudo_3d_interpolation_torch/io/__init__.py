"""Host-side data: the in-memory cube, its netCDF files and the SEG-Y
codec."""
