"""Platform helpers."""
