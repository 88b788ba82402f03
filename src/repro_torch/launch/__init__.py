"""Command-line entry points of the port (reference: ``repro.launch``)."""
