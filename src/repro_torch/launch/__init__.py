"""Placement of a run on devices: ``mesh`` (the mesh of a plan's axes
over one torch device per shard)."""
