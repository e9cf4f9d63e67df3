"""Command-line entry points of the port, as `repro/launch`."""
