"""The benchmark's plain reference: the seeded cube, the shearlet windows
and the solve stage in plain PyTorch and numpy. Nothing here imports the
program under test."""
