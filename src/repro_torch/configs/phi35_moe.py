"""phi3.5-moe-42b-a6.6b [moe]: 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct]. 32L d_model=4096 32H (GQA kv=8)
d_ff=6400 vocab=32064."""
import dataclasses

from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="phi3.5-moe", family="moe", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=6400, vocab_size=32064,
    num_experts=16, top_k=2,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=64, num_experts=4, top_k=2,
)
