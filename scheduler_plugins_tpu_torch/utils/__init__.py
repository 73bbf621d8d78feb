"""Integer math helpers."""
