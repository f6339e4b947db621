"""Models of the port: CosmoFlow (``cosmoflow``), the 3D U-Net
(``unet3d``), the Mamba2 LM and the Zamba2 hybrid (``ssm_lm``,
``mamba2``), and the transformer families (``transformer``, ``moe``,
``frontends``)."""


def for_config(cfg):
    """The model module of a ``ConvNetConfig``: ``unet3d`` for the U-Net,
    else ``cosmoflow``."""
    from repro_torch.models import cosmoflow, unet3d

    return unet3d if cfg.arch == "unet3d" else cosmoflow


def lm_module(cfg):
    """The model module of a language-model config: ``ssm_lm`` for an
    ``SSMConfig`` or ``HybridConfig``, ``transformer`` for a
    ``TransformerConfig``. Both take (params, ..., cfg) with the same
    entry points (``init_params``, ``params_from_numpy``, ``forward``,
    ``lm_loss``, ``init_cache``, ``decode_step``, ``prefill``)."""
    from repro_torch.configs.base import (HybridConfig, SSMConfig,
                                          TransformerConfig)
    from repro_torch.models import ssm_lm, transformer

    if isinstance(cfg, (SSMConfig, HybridConfig)):
        return ssm_lm
    if isinstance(cfg, TransformerConfig):
        return transformer
    raise TypeError(f"{getattr(cfg, 'name', cfg)!r} is not a language-model "
                    "config (SSMConfig, HybridConfig or TransformerConfig)")
