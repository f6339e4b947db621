"""mamba2-370m [ssm]: SSD (state-space duality) [arXiv:2405.21060].
48L d_model=1024 (attention-free) vocab=50280, ssm_state=128."""
import dataclasses

from repro_torch.configs.base import SSMConfig

CONFIG = SSMConfig(
    name="mamba2-370m", family="ssm", num_layers=48, d_model=1024,
    ssm_state=128, vocab_size=50280, expand=2, head_dim=64,
    chunk_size=256,
)

SMOKE = dataclasses.replace(
    CONFIG, num_layers=2, d_model=64, ssm_state=16, vocab_size=64,
    head_dim=16, chunk_size=8,
)
