"""Core layers of the port (decoding, serving)."""
