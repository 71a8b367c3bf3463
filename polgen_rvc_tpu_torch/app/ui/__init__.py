"""The web UI: one static page and its HTTP server (server.py)."""
