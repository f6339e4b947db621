"""SSD (Mamba2) chunked scan: ``ops.ssd_scan`` (kernel) and
``ref.ssd_scan`` (plain version)."""
