"""Rendering a field of pixels and the inverse-rendering step (dist/render.py)."""
