"""``pack`` / ``unpack``: the halo pack and unpack kernels' wrappers.

On a CUDA tensor each checks what its kernel takes, allocates the output
and launches ``csrc/halo_pack.cu`` on the current stream, adding one to
``pack.launches`` / ``unpack.launches``; anything the kernel does not
take raises. On a CPU tensor each runs its plain version in ``ref.py``.
There is no fallback to the plain version or to ``torch.cat`` for a CUDA
tensor.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.halo_pack import ref
from repro_torch.kernels.halo_pack.ref import PackedFaces

_MAX_SEGMENTS = 65535  # blockIdx.y: 2 runs a sample for pack, 3 for unpack


def _entry(name: str, n_ptrs: int):
    fn = getattr(_build.load("halo_pack"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_longlong] * 3
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_x(x: torch.Tensor, what: str) -> None:
    if x.dim() != 5 or not x.is_floating_point():
        raise ValueError(f"{what} takes a floating (N, D, H, W, C) tensor; "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on CPU or CUDA tensors, not "
                         f"{x.device}")


def _row_bytes(x: torch.Tensor) -> int:
    return math.prod(x.shape[2:]) * x.element_size()


def pack(x: torch.Tensor, lo: int, hi: int) -> PackedFaces:
    """x: (N, D, H, W, C) contiguous -> ONE buffer holding its trailing
    ``lo`` depth rows (``to_next``) then its leading ``hi`` rows
    (``to_prev``), each part contiguous; 0 <= lo, hi <= D."""
    _check_x(x, "pack")
    lo, hi = int(lo), int(hi)
    if not (0 <= lo <= x.shape[1] and 0 <= hi <= x.shape[1]):
        raise ValueError(f"pack widths lo={lo}, hi={hi} outside [0, D="
                         f"{x.shape[1]}]")
    if x.device.type == "cpu":
        return ref.pack(x, lo, hi)
    if not x.is_contiguous():
        raise ValueError("pack's kernel takes a contiguous x")
    if 2 * x.shape[0] > _MAX_SEGMENTS:
        raise ValueError(f"pack's kernel takes at most "
                         f"{_MAX_SEGMENTS // 2} samples")
    n, d = x.shape[:2]
    buf = torch.empty(n * (lo + hi) * math.prod(x.shape[2:]),
                      dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _entry("halo_pack", 2)(
            x.data_ptr(), buf.data_ptr(), n, d, _row_bytes(x), lo, hi,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "halo_pack")
    _build.count_launch(pack)
    return ref.faces(buf, x.shape, lo, hi)


def unpack(x: torch.Tensor, lo_buf: Optional[torch.Tensor],
           hi_buf: Optional[torch.Tensor]) -> torch.Tensor:
    """[lo_buf | x | hi_buf] along depth, written in one pass into one
    (N, D + lo + hi, H, W, C) buffer. x, lo_buf (N, lo, H, W, C) and
    hi_buf (N, hi, H, W, C) contiguous, on one device, of one dtype; a
    None buffer is a width of 0."""
    _check_x(x, "unpack")
    n, d, h, w, c = x.shape
    for name, b in (("lo_buf", lo_buf), ("hi_buf", hi_buf)):
        if b is None:
            continue
        if (b.dim() != 5 or (b.shape[0],) + tuple(b.shape[2:])
                != (n, h, w, c)):
            raise ValueError(f"{name} {tuple(b.shape)} does not fit x "
                             f"{tuple(x.shape)} along depth")
        if b.dtype != x.dtype or b.device != x.device:
            raise ValueError(f"{name} is {b.dtype} on {b.device}; x is "
                             f"{x.dtype} on {x.device}")
    if x.device.type == "cpu":
        return ref.unpack(x, lo_buf, hi_buf)
    parts = [t for t in (lo_buf, x, hi_buf) if t is not None]
    if not all(t.is_contiguous() for t in parts):
        raise ValueError("unpack's kernel takes contiguous x, lo_buf and "
                         "hi_buf")
    if 3 * n > _MAX_SEGMENTS:
        raise ValueError(f"unpack's kernel takes at most "
                         f"{_MAX_SEGMENTS // 3} samples")
    lo = 0 if lo_buf is None else lo_buf.shape[1]
    hi = 0 if hi_buf is None else hi_buf.shape[1]
    out = torch.empty((n, lo + d + hi, h, w, c), dtype=x.dtype,
                      device=x.device)
    with torch.cuda.device(x.device):
        err = _entry("halo_unpack", 4)(
            None if lo_buf is None else lo_buf.data_ptr(), x.data_ptr(),
            None if hi_buf is None else hi_buf.data_ptr(), out.data_ptr(), n,
            d, _row_bytes(x), lo, hi,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "halo_unpack")
    _build.count_launch(unpack)
    return out


pack.launches = 0
unpack.launches = 0
