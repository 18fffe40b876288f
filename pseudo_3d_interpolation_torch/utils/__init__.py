"""Host and device helpers: the device rule, chunking, rescaling, the CRS
engine and the console logger."""
