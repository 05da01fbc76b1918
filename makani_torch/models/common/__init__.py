"""Layers shared by the networks."""
