"""Direct 3-D convolution: ``ops.conv3d_valid`` (kernel) and
``ref.conv3d_valid`` (plain version)."""
