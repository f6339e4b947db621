"""Config dataclasses of the port's model families: the paper's 3-D CNN
(CosmoFlow Table I / 3D U-Net, ``ConvNetConfig``), the transformer
families (dense, MoE, VLM, audio: ``TransformerConfig``), the Mamba2 /
SSD language models (``SSMConfig``) and the Zamba2 hybrid
(``HybridConfig``), with the four LM input shapes (``INPUT_SHAPES``).
Pure data: model code consumes them, ``repro_torch.configs`` selects
them by name. Copies of the reference's classes, field for field, so a
config read from a reference checkpoint's JSON builds the same object."""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Decoder-only / encoder-only transformer family (dense, MoE, VLM, audio).

    Covers: hubert-xlarge, phi3.5-moe, gemma2-2b, arctic-480b, phi3-mini,
    phi-3-vision, llama3-405b, qwen1.5-0.5b, and the attention block of
    zamba2.
    """

    name: str
    family: str  # dense | moe | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # --- attention variants ---
    causal: bool = True  # False for encoder-only (hubert)
    rope_theta: float = 10_000.0
    sliding_window: int = 0  # >0: local attention window (gemma2 local layers)
    alt_local_global: bool = False  # gemma2: alternate local/global layers
    logit_softcap: float = 0.0  # gemma2 final-logit softcapping
    attn_softcap: float = 0.0  # gemma2 attention-logit softcapping
    qkv_bias: bool = False  # qwen1.5
    # --- MoE ---
    num_experts: int = 0  # 0 -> dense FFN
    top_k: int = 0
    moe_dense_residual: bool = False  # arctic: dense FFN residual alongside MoE
    dense_residual_d_ff: int = 0
    # --- norm / act ---
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    activation: str = "silu"  # silu (SwiGLU) | gelu (plain MLP, hubert)
    gated_mlp: bool = True
    tie_embeddings: bool = False
    # --- modality frontend stub (audio/vlm): inputs are embeddings ---
    embed_inputs: bool = True  # False: input_specs provides (B,S,d_model) floats
    # --- applicability flags ---
    supports_decode: bool = True  # False for encoder-only
    subquadratic: bool = False  # True if sliding-window etc. enables long_500k

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + norms)."""
        hd = self.resolved_head_dim
        d = self.d_model
        attn = d * hd * self.num_heads + 2 * d * hd * self.num_kv_heads \
            + hd * self.num_heads * d
        if self.qkv_bias:
            attn += hd * (self.num_heads + 2 * self.num_kv_heads)
        if self.gated_mlp:
            ffn_dense = 3 * d * self.d_ff
        else:
            ffn_dense = 2 * d * self.d_ff
        if self.num_experts:
            ffn = self.num_experts * ffn_dense + d * self.num_experts
            if self.moe_dense_residual:
                dr = self.dense_residual_d_ff or self.d_ff
                ffn += 3 * d * dr
        else:
            ffn = ffn_dense
        block = attn + ffn + 2 * d  # two norms
        emb = self.vocab_size * d
        out = 0 if self.tie_embeddings else self.vocab_size * d
        return self.num_layers * block + emb + out + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if not self.num_experts:
            return self.param_count()
        hd = self.resolved_head_dim
        d = self.d_model
        attn = d * hd * self.num_heads + 2 * d * hd * self.num_kv_heads \
            + hd * self.num_heads * d
        ffn_one = 3 * d * self.d_ff if self.gated_mlp else 2 * d * self.d_ff
        ffn = self.top_k * ffn_one + d * self.num_experts
        if self.moe_dense_residual:
            dr = self.dense_residual_d_ff or self.d_ff
            ffn += 3 * d * dr
        block = attn + ffn + 2 * d
        emb = self.vocab_size * d
        out = 0 if self.tie_embeddings else self.vocab_size * d
        return self.num_layers * block + emb + out + d


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


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: Mamba2 backbone + periodically-applied shared
    attention block (the same attention params reused at several depths)."""

    name: str
    family: str  # hybrid
    num_layers: int  # number of mamba2 blocks
    d_model: int
    ssm_state: int
    vocab_size: int
    # shared attention block
    num_heads: int = 32
    num_kv_heads: int = 32
    d_ff: int = 8192
    attn_every: int = 6  # apply shared attn block every k mamba layers
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256
    conv_width: int = 4
    norm: str = "rmsnorm"
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    supports_decode: bool = True
    subquadratic: bool = True  # attn blocks see compressed context / windowed

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def num_ssm_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def num_attn_applications(self) -> int:
        return self.num_layers // self.attn_every

    def param_count(self) -> int:
        ssm = SSMConfig(
            name="_", family="ssm", num_layers=self.num_layers,
            d_model=self.d_model, ssm_state=self.ssm_state,
            vocab_size=self.vocab_size, expand=self.expand,
            head_dim=self.head_dim, chunk_size=self.chunk_size,
            conv_width=self.conv_width, tie_embeddings=self.tie_embeddings,
        ).param_count()
        d = self.d_model
        hd = d // self.num_heads
        attn = d * hd * self.num_heads * 2 + 2 * d * hd * self.num_kv_heads \
            + 3 * d * self.d_ff + 2 * d
        return ssm + attn  # shared => counted once

    def active_param_count(self) -> int:
        return self.param_count()
