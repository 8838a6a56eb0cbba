"""Host-side utilities: the msgpack tree format, metric writers, plots and volume
views, seeds, FLOP counts, profiling and numerical checks."""
