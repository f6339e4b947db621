"""Halo pack and unpack along depth: ``ops.pack`` / ``ops.unpack``
(kernels) and ``ref.pack`` / ``ref.unpack`` (plain versions)."""
