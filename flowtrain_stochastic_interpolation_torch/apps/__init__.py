"""Command-line applications of the port (``python -m ...apps.<name>``)."""
