"""Layers and the net of the port."""
