"""Core layers of the port: precision policies, in-process SPMD over a
mesh (``spmd``), halo exchange, the spatial conv and pooling,
distributed batch norm, resharding at plan stage boundaries,
parallelism plans, lowering flags and fault injection."""
