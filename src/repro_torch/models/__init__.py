"""Models of the port: CosmoFlow (``cosmoflow``). The 3D U-Net joins with
its slice."""
