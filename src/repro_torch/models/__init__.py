"""Models of the port: CosmoFlow (``cosmoflow``), the 3D U-Net
(``unet3d``) and the Mamba2 LM (``ssm_lm``, ``mamba2``)."""


def for_config(cfg):
    """The model module of a ``ConvNetConfig``: ``unet3d`` for the U-Net,
    else ``cosmoflow``."""
    from repro_torch.models import cosmoflow, unet3d

    return unet3d if cfg.arch == "unet3d" else cosmoflow
