"""Host and device helpers: the device rule, chunking, rescaling."""
