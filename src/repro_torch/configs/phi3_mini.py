"""phi3-mini-3.8b [dense]: RoPE SwiGLU GQA [arXiv:2404.14219].
32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064."""
import dataclasses

from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="phi3-mini", family="dense", num_layers=32, d_model=3072,
    num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=32064,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=64,
)
