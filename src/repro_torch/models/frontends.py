"""Modality frontend stubs (the reference's ``models/frontends.py``).

[audio] hubert-xlarge: the mel-spectrogram + conv feature extractor is
not implemented; the encoder consumes precomputed frame embeddings of
shape (B, S, d_model) (``audio_embed_shape``).

[vlm] phi-3-vision: the CLIP vision tower + projector is not
implemented; projected patch embeddings of shape (B, S_img, d_model)
(``vision_embed_shape``) are prepended to the text embeddings.

The synthetic embeddings draw from an explicit ``torch.Generator`` on
its device.
"""
from __future__ import annotations

from typing import Tuple

import torch

# phi-3-vision: number of image tokens contributed by the (stubbed) vision
# tower for one image at base resolution (CLIP ViT-L/14 336px -> 576 + sep).
NUM_IMAGE_TOKENS = 1024


def audio_embed_shape(batch: int, seq: int,
                      d_model: int) -> Tuple[int, int, int]:
    return (batch, seq, d_model)


def vision_embed_shape(batch: int, d_model: int) -> Tuple[int, int, int]:
    return (batch, NUM_IMAGE_TOKENS, d_model)


def synth_audio_embeds(generator: torch.Generator, batch: int, seq: int,
                       d_model: int,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Synthetic frame embeddings for smoke tests/examples."""
    return torch.randn(audio_embed_shape(batch, seq, d_model),
                       generator=generator, device=generator.device,
                       dtype=dtype) * 0.02


def synth_vision_embeds(generator: torch.Generator, batch: int, d_model: int,
                        num_tokens: int = NUM_IMAGE_TOKENS,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.randn((batch, num_tokens, d_model), generator=generator,
                       device=generator.device, dtype=dtype) * 0.02
