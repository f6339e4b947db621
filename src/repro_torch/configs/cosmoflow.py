"""CosmoFlow (paper Table I, extended model of SIV): n=log2(W)-2 conv
blocks, channels (16,32,64,128,256,256,256), batch-norm, FC 2048-256-4.
Variants for 128^3 / 256^3 / 512^3 input volumes."""
from repro_torch.configs.base import ConvNetConfig


def config_for_width(width: int) -> ConvNetConfig:
    return ConvNetConfig(
        name=f"cosmoflow-{width}", family="conv3d", arch="cosmoflow",
        input_width=width, in_channels=4, out_dim=4, batchnorm=True,
    )


CONFIG = config_for_width(512)

SMOKE = ConvNetConfig(
    name="cosmoflow-smoke", family="conv3d", arch="cosmoflow",
    input_width=32, in_channels=2, out_dim=4,
    conv_channels=(4, 8, 16), fc_dims=(64, 32), batchnorm=True,
)
