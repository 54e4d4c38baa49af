"""Placement of the decoder's lane axis over a device mesh."""
