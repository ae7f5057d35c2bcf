"""Traffic drivers, one module a ``kind`` of traffic file: each builds a
cell's program from the configuration, runs its measured window and judges
what the window produced against ``benchmark/reference``."""
