"""arctic-480b [moe]: 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base]. 35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000."""
import dataclasses

from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="arctic-480b", family="moe", num_layers=35, d_model=7168,
    num_heads=56, num_kv_heads=8, d_ff=4864, vocab_size=32000,
    num_experts=128, top_k=2, moe_dense_residual=True,
    dense_residual_d_ff=4864,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=64, num_experts=4, top_k=2,
    dense_residual_d_ff=128,
)
