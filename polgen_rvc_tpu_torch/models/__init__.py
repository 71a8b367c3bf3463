"""Models as functions of parameter dictionaries."""
