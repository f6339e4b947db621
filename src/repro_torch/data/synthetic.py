"""Synthetic datasets (the port's own copy of the reference's
``data/synthetic.py``: numpy only, so that a seed gives the same bytes
in both packages, the LM corpus ``make_token_dataset`` included).

``make_cosmology_dataset`` generates 3-D Gaussian-random-field "universes"
whose POWER SPECTRUM is controlled by the regression targets — by
construction the targets are encoded in LONG-RANGE (low-k) structure, so a
model that sees the full cube can recover them while a model trained on
sub-volumes cannot resolve the lowest-k modes. This reproduces the
*mechanism* behind paper Fig. 9/10 (full-resolution training => an order-
of-magnitude better MSE) without the 9.77 TiB NERSC dataset.

Parameters (normalized to [-1, 1], mirroring the paper's 4 targets):
  y0 ~ amplitude (sigma_8), y1 ~ spectral tilt (n_s),
  y2 ~ damping scale (H_0 proxy), y3 ~ mean density (Omega_M proxy).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _grf_cube(rng: np.random.Generator, w: int, y: np.ndarray) -> np.ndarray:
    """Gaussian random field whose 4 targets control distinct spectral
    features. Crucially y0 (and partly y1) live in integer mode numbers
    n < 2.5 — wavelengths LONGER than a half-cube, which a factor-2
    sub-volume cannot represent at all; y2/y3 are local controls. The
    field is normalized by its ANALYTIC variance (a per-cube empirical
    normalization would erase the amplitude signal)."""
    nx = np.fft.fftfreq(w)[:, None, None] * w
    ny = np.fft.fftfreq(w)[None, :, None] * w
    nz = np.fft.rfftfreq(w)[None, None, :] * w
    n = np.sqrt(nx ** 2 + ny ** 2 + nz ** 2)  # integer mode number
    n_safe = np.where(n < 1e-9, 1.0, n)
    # Each target sets the log-power of one k-band (band powers are how
    # spectra are parameterized observationally). Band edges scale with w
    # so a factor-2 sub-volume loses band 0 entirely (wavelength > its
    # box) and half of band 1 — the long-range information of Fig. 9.
    edges = np.array([1.0, 2.5, 5.0, 10.0, 16.0]) * (w / 32.0)
    pk = n_safe ** -1.0  # base shape
    for i in range(4):
        band = (n >= edges[i]) & (n < edges[i + 1])
        pk = np.where(band, pk * np.exp(1.4 * y[i]), pk)
    pk[0, 0, 0] = 0.0
    pk = np.where(n >= edges[-1], pk * 0.05, pk)  # quiet high-k tail
    noise = (rng.normal(size=(w, w, w // 2 + 1))
             + 1j * rng.normal(size=(w, w, w // 2 + 1)))
    field = np.fft.irfftn(noise * np.sqrt(pk), s=(w, w, w), axes=(0, 1, 2))
    # fixed (y-independent) scale so the band-power signal survives
    ref_std = np.sqrt(2.0 * (n_safe ** -1.0)[n >= 1].sum()) / w ** 1.5
    field = field / ref_std * 0.3
    return field.astype(np.float32)


def make_cosmology_dataset(
    num_samples: int,
    width: int,
    channels: int = 1,
    seed: int = 0,
) -> Tuple[list, np.ndarray]:
    """Returns (cubes [(D,H,W,C)], targets (N,4) in [-1,1])."""
    rng = np.random.default_rng(seed)
    cubes, targets = [], []
    for _ in range(num_samples):
        y = rng.uniform(-1, 1, size=4)
        chans = [_grf_cube(rng, width, y) for _ in range(channels)]
        cubes.append(np.stack(chans, axis=-1))
        targets.append(y)
    return cubes, np.asarray(targets, np.float32)


def split_into_subvolumes(cubes, targets, factor: int):
    """Split each W^3 cube into factor^3 sub-volumes that inherit the parent
    targets — the original CosmoFlow workaround the paper argues against."""
    out_c, out_t = [], []
    for c, t in zip(cubes, targets):
        w = c.shape[0] // factor
        for i in range(factor):
            for j in range(factor):
                for k in range(factor):
                    out_c.append(
                        c[i * w:(i + 1) * w, j * w:(j + 1) * w,
                          k * w:(k + 1) * w])
                    out_t.append(t)
    return out_c, np.asarray(out_t, np.float32)


def make_segmentation_dataset(
    num_samples: int, width: int, num_classes: int = 3,
    channels: int = 1, seed: int = 0,
):
    """Synthetic LiTS stand-in: blobby foreground classes in a noisy volume."""
    rng = np.random.default_rng(seed)
    cubes, labels = [], []
    gx, gy, gz = np.meshgrid(*([np.arange(width)] * 3), indexing="ij")
    for _ in range(num_samples):
        lab = np.zeros((width,) * 3, np.int32)
        vol = rng.normal(0, 0.3, size=(width,) * 3).astype(np.float32)
        for cls in range(1, num_classes):
            cx, cy, cz = rng.uniform(0, width, 3)
            r = rng.uniform(width * 0.1, width * 0.3)
            mask = ((gx - cx) ** 2 + (gy - cy) ** 2 + (gz - cz) ** 2) < r ** 2
            lab[mask] = cls
            vol[mask] += 0.5 * cls
        chans = [vol for _ in range(channels)]
        cubes.append(np.stack(chans, axis=-1))
        labels.append(lab)
    return cubes, labels


def make_token_dataset(
    num_tokens: int, vocab: int, seed: int = 0, order: int = 2,
) -> np.ndarray:
    """Synthetic LM corpus: a sparse Markov chain so that models can reach
    non-trivial loss (< log V) within a few hundred steps. int32 tokens,
    the reference's bytes for the same arguments (``order`` is unused,
    as there)."""
    rng = np.random.default_rng(seed)
    # each (prev % 64) state prefers a small set of successors
    n_states = 64
    succ = rng.integers(0, vocab, size=(n_states, 8))
    toks = np.empty(num_tokens, np.int32)
    toks[0] = rng.integers(vocab)
    r = rng.random(num_tokens)
    choice = rng.integers(0, 8, size=num_tokens)
    for t in range(1, num_tokens):
        if r[t] < 0.8:
            toks[t] = succ[toks[t - 1] % n_states, choice[t]]
        else:
            toks[t] = rng.integers(vocab)
    return toks
