"""The benchmark's plain reference, written from the published semantics
and independent of the program: ``ssp`` builds the hexagonal SSP space and
the oscillators' Fourier maps, ``vco`` draws and solves the VCO bank and
scans it, ``pi`` holds the fast path's episodes to them and ``check``
holds the comparisons.  Nothing here imports the program or takes a table
it made; what it made is read only to be judged."""
