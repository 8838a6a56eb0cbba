"""Host-side utilities: the msgpack tree format, metric writers, files, plots, seeds."""
