"""phi-3-vision-4.2b [vlm]: phi3-mini backbone + CLIP vision tower
[hf:microsoft/Phi-3-vision-128k-instruct]. The vision tower + projector is
a stub (models/frontends.py); input_specs provide projected patch
embeddings prepended to the text embeddings."""
import dataclasses

from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="phi3-vision", family="vlm", num_layers=32, d_model=3072,
    num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=32064,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=64,
)
