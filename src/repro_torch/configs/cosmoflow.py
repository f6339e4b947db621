"""CosmoFlow (paper Table I, extended model of SIV): n=log2(W)-2 conv
blocks, channels (16,32,64,128,256,256,256), batch-norm, FC 2048-256-4.
Variants for 128^3 / 256^3 / 512^3 input volumes.

``run_preset()`` is the canonical run of the CosmoFlow example
(``repro_torch.examples.train_cosmoflow``): the ~100M-parameter variant
of ``big_config``."""
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


def big_config(width: int = 64) -> ConvNetConfig:
    """The ~100M-parameter CosmoFlow variant of the example: one input
    channel, conv channels up to 512 and a 2048-256 head."""
    return ConvNetConfig(
        name=f"cosmoflow-big-{width}", family="conv3d", arch="cosmoflow",
        input_width=width, in_channels=1, out_dim=4,
        conv_channels=(32, 64, 128, 256, 512), fc_dims=(2048, 256),
        batchnorm=True)


def run_preset(width: int = 64):
    """The canonical ``RunConfig`` of the CosmoFlow example: ``big_config``,
    global batch 4, LR 1e-3 linearly decayed over 300 steps, grad clip
    1.0."""
    from repro_torch.api.config import RunConfig  # api imports configs

    return RunConfig(model=big_config(width), global_batch=4,
                     lr=1e-3, lr_schedule="linear_decay", grad_clip=1.0,
                     total_steps=300)
