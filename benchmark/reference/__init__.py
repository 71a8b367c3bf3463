"""The plain reference of a conversion, frozen from the port's plain paths
and the published models' equations: PyTorch and NumPy only, no import of
the port, nothing it made. ``convert.reference_convert`` is the entry."""
