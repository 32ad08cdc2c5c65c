"""Process-level helpers (logging)."""
