"""hubert-xlarge [audio]: encoder-only, same arch as wav2vec2
[arXiv:2106.07447]. 48L d_model=1280 16H (GQA kv=16) d_ff=5120 vocab=504.
The conv feature-extractor frontend is a stub (models/frontends.py); the
encoder consumes precomputed frame embeddings. Plain (non-gated) GELU MLP,
bidirectional attention, per-frame masked-prediction targets."""
import dataclasses

from repro_torch.configs.base import TransformerConfig

CONFIG = TransformerConfig(
    name="hubert-xlarge", family="audio", num_layers=48, d_model=1280,
    num_heads=16, num_kv_heads=16, d_ff=5120, vocab_size=504,
    causal=False, gated_mlp=False, activation="gelu",
    embed_inputs=False, supports_decode=False, subquadratic=False,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=64,
)
