"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention block
[arXiv:2411.15242]. 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64."""
import dataclasses

from repro_torch.configs.base import HybridConfig

CONFIG = HybridConfig(
    name="zamba2-1.2b", family="hybrid", num_layers=38, d_model=2048,
    ssm_state=64, vocab_size=32000, num_heads=32, num_kv_heads=32,
    d_ff=8192, attn_every=6, head_dim=64, chunk_size=256,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, ssm_state=16, vocab_size=64,
    num_heads=4, num_kv_heads=4, d_ff=128, attn_every=2, head_dim=16,
    chunk_size=8,
)
