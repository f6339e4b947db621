"""llama3-405b [dense]: GQA, 128k vocab [arXiv:2407.21783].
126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256."""
import dataclasses

from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="llama3-405b", family="dense", num_layers=126, d_model=16384,
    num_heads=128, num_kv_heads=8, d_ff=53248, vocab_size=128256,
    rope_theta=500000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=128, num_heads=8, num_kv_heads=2,
    d_ff=256, vocab_size=128,
)
