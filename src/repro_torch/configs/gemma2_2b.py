"""gemma2-2b [dense]: local+global alternating attention, logit softcap
[arXiv:2408.00118]. 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000,
head_dim=256, sliding_window=4096, attn softcap 50, final softcap 30.
Sliding-window layers make long_500k runnable (sub-quadratic locals; the
alternating global layers attend to the full sharded cache)."""
import dataclasses

from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="gemma2-2b", family="dense", num_layers=26, d_model=2304,
    num_heads=8, num_kv_heads=4, d_ff=9216, vocab_size=256000,
    head_dim=256, sliding_window=4096, alt_local_global=True,
    logit_softcap=30.0, attn_softcap=50.0, subquadratic=True, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=64, head_dim=16, sliding_window=16,
)
