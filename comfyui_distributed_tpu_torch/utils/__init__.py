"""Host-side helpers (image file output)."""
