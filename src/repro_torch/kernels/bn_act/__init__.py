"""Fused batch-norm + leaky-ReLU: ``ops.bn_leaky_relu`` (kernel) and
``ref.bn_leaky_relu`` (plain version)."""
