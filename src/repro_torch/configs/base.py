"""Config dataclass of the paper's 3-D CNN family (CosmoFlow Table I /
3D U-Net). Pure data: model code consumes it, ``repro_torch.configs``
selects it by name. A copy of the reference's ``ConvNetConfig``, field
for field, so a config read from a reference checkpoint's JSON builds
the same object."""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ConvNetConfig:
    """The paper's own 3D CNN family (CosmoFlow Table I / 3D U-Net)."""

    name: str
    family: str  # conv3d
    arch: str  # cosmoflow | unet3d
    input_width: int  # cubic spatial size (128/256/512)
    in_channels: int
    out_dim: int  # regression targets (cosmoflow) or seg classes (unet)
    conv_channels: Sequence[int] = (16, 32, 64, 128, 256, 256, 256)
    kernel_size: int = 3
    fc_dims: Sequence[int] = (2048, 256)
    batchnorm: bool = True
    base_channels: int = 32  # unet3d
    depth: int = 4  # unet3d levels

    def param_count(self) -> int:
        if self.arch == "cosmoflow":
            k3 = self.kernel_size ** 3
            total, cin = 0, self.in_channels
            w = self.input_width
            npool = min(int(math.log2(w)) - 2, len(self.conv_channels))
            for i, c in enumerate(self.conv_channels):
                total += k3 * cin * c + (2 * c if self.batchnorm else 0)
                cin = c
                if i == 3:
                    w //= 2  # stride-2 conv in block 4
                if i < npool:
                    w //= 2
            flat = cin * w ** 3
            dims = list(self.fc_dims) + [self.out_dim]
            for dout in dims:
                total += flat * dout + dout
                flat = dout
            return total
        # unet3d: encoder/decoder with doubling channels
        k3 = self.kernel_size ** 3
        total, cin = 0, self.in_channels
        ch = self.base_channels
        enc = []
        for _ in range(self.depth):
            total += k3 * cin * ch + k3 * ch * (2 * ch) + 4 * ch + 4 * ch
            enc.append(2 * ch)
            cin = 2 * ch
            ch *= 2
        # bottleneck
        total += k3 * cin * ch + k3 * ch * 2 * ch
        up_in = 2 * ch
        for skip in reversed(enc):
            total += 2 ** 3 * up_in * skip  # deconv
            total += k3 * (2 * skip) * skip + k3 * skip * skip
            up_in = skip
        total += up_in * self.out_dim
        return total

    def active_param_count(self) -> int:
        return self.param_count()
