"""Config dataclasses of the port's model families: the paper's 3-D CNN
(CosmoFlow Table I / 3D U-Net, ``ConvNetConfig``) and the Mamba2 / SSD
language models (``SSMConfig``). Pure data: model code consumes them,
``repro_torch.configs`` selects them by name. Copies of the reference's
classes, field for field, so a config read from a reference
checkpoint's JSON builds the same object."""
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


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD (state-space duality) family."""

    name: str
    family: str  # ssm
    num_layers: int
    d_model: int
    ssm_state: int  # N: state dimension
    vocab_size: int
    expand: int = 2  # d_inner = expand * d_model
    head_dim: int = 64  # SSD head dim P
    chunk_size: int = 256  # SSD block size
    conv_width: int = 4  # short causal conv
    norm: str = "rmsnorm"
    tie_embeddings: bool = True
    supports_decode: bool = True
    subquadratic: bool = True

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def num_ssm_heads(self) -> int:
        return self.d_inner // self.head_dim

    def param_count(self) -> int:
        d, di = self.d_model, self.d_inner
        nh, ns = self.num_ssm_heads, self.ssm_state
        in_proj = d * (2 * di + 2 * ns + nh)  # z, x, B, C, dt
        conv = self.conv_width * (di + 2 * ns)
        out_proj = di * d
        extras = 2 * nh + di  # A_log, D, gated-norm scale
        block = in_proj + conv + out_proj + extras + d
        emb = self.vocab_size * d
        out = 0 if self.tie_embeddings else self.vocab_size * d
        return self.num_layers * block + emb + out + d

    def active_param_count(self) -> int:
        return self.param_count()
