"""Image I/O helpers."""
