"""Layers, the net and the remat policies of the port."""
