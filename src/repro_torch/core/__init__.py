"""Core layers of the port: precision policies, distributed batch
norm, the spatial conv and pooling, halo widths, parallelism plans and
fault injection. One device: every mesh axis has degree 1."""
