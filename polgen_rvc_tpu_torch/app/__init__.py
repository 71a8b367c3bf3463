"""File-level entry points of the port: the voice-conversion pipeline and its CLI."""
