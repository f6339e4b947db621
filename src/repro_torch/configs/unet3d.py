"""3D U-Net (Cicek et al., MICCAI 2016) at 256^3 (paper SII-C/SV-A):
3 encoder levels + bottleneck, base 32 channels, deconv upsampling,
per-voxel softmax over 3 classes (LiTS liver/lesion/background).

``run_preset()`` is the canonical run of the U-Net: the smoke variant by
default, LR 1e-3 linearly decayed over 30 steps."""
from repro_torch.configs.base import ConvNetConfig

CONFIG = ConvNetConfig(
    name="unet3d-256", family="conv3d", arch="unet3d", input_width=256,
    in_channels=1, out_dim=3, base_channels=32, depth=3, batchnorm=True,
)

SMOKE = ConvNetConfig(
    name="unet3d-smoke", family="conv3d", arch="unet3d", input_width=16,
    in_channels=1, out_dim=3, base_channels=4, depth=2, batchnorm=True,
)


def run_preset(full: bool = False):
    """The canonical ``RunConfig`` of the U-Net: ``SMOKE`` unless
    ``full``, global batch 2, LR 1e-3 linearly decayed over 30 steps."""
    from repro_torch.api.config import RunConfig  # api imports configs

    return RunConfig(model=CONFIG if full else SMOKE, global_batch=2,
                     lr=1e-3, lr_schedule="linear_decay", total_steps=30)
