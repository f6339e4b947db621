"""``ssd_scan``: the SSD chunked-scan kernel's wrapper (forward only).

On a CUDA tensor it checks what the kernel takes, allocates ``y``, the
final state and the kernel's scratch (one fp32 (P, N) state per chunk
and head, and each chunk's summed decay exponent), and launches
``csrc/ssd_scan.cu`` on the current stream, adding one to
``ssd_scan.launches``; anything the kernel does not take raises. On a
CPU tensor it runs the plain version in ``ref.py``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import ref

_ENTRY = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
# the output pass keeps 2 heads' cumulative decays and steps (4 * Q fp32)
# beside 68 KB of tiles in shared memory: Q <= 4096 fits in 227 KB
MAX_CHUNK = 4096


def chunk_len(L: int, chunk: int) -> int:
    """The chunk the kernel uses: ``min(chunk, L)``, lowered until it
    divides L (as ``repro.kernels.ssd_scan.kernel.ssd_scan_chunked``
    does)."""
    q = min(chunk, L)
    while L % q:
        q -= 1
    return q


def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("ssd_scan"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int64] * 2
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(x, dt, A, Bm, Cm, chunk) -> None:
    if x.dim() != 4:
        raise ValueError(f"ssd_scan takes x as (B, L, H, P); got "
                         f"{tuple(x.shape)}")
    Bb, L, H, P = x.shape
    if Bm.dim() != 3:
        raise ValueError(f"ssd_scan takes Bm as (B, L, N); got "
                         f"{tuple(Bm.shape)}")
    N = Bm.shape[-1]
    want = {"dt": (Bb, L, H), "A": (H,), "Bm": (Bb, L, N), "Cm": (Bb, L, N)}
    for name, v in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if tuple(v.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]} for x of shape "
                             f"{tuple(x.shape)}; got {tuple(v.shape)}")
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
    for name, v in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if not v.is_floating_point():
            raise TypeError(f"{name} must be floating point; got {v.dtype}")
    if min(Bb, L, H, P, N) < 1:
        raise ValueError(f"ssd_scan takes no empty dimension; got x "
                         f"{tuple(x.shape)}, N={N}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1; got {chunk}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, H, P); dt: (B, L, H) post-softplus; A: (H,) negative;
    Bm/Cm: (B, L, N), one group shared by every head. Returns y
    (B, L, H, P) in x's dtype and the final state (B, H, P, N) in fp32.
    The kernel works in chunks of ``chunk_len(L, chunk)`` steps; the
    plain version is sequential."""
    chunk = int(chunk)
    _check(x, dt, A, Bm, Cm, chunk)
    if x.device.type == "cpu":
        return ref.ssd_scan(x, dt, A, Bm, Cm)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CPU or CUDA tensors, not "
                         f"{x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"ssd_scan's kernel takes x among "
                        f"{sorted(str(d) for d in _ENTRY)}; got {x.dtype}")
    for name, v in (("dt", dt), ("Bm", Bm), ("Cm", Cm)):
        if v.dtype != x.dtype:
            raise TypeError(f"ssd_scan's kernel takes {name} in x's dtype "
                            f"{x.dtype}; got {v.dtype}")
    if A.dtype != torch.float32:
        raise TypeError(f"ssd_scan's kernel takes A in float32; got "
                        f"{A.dtype}")
    for name, v in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm)):
        if not v.is_contiguous():
            raise ValueError(f"ssd_scan's kernel takes a contiguous {name}")
    Bb, L, H, P = x.shape
    N = Bm.shape[-1]
    q = chunk_len(L, chunk)
    if q > MAX_CHUNK:
        raise ValueError(f"chunk {q} above the kernel's {MAX_CHUNK}")
    nc = L // q
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    state = torch.empty((Bb, H, P, N), **f32)
    chunk_states = torch.empty((Bb, nc, H, P, N), **f32)
    chunk_decay = torch.empty((Bb, nc, H), **f32)
    with torch.cuda.device(x.device):
        err = _entry(x.dtype)(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
            chunk_states.data_ptr(), chunk_decay.data_ptr(), Bb, L, H, P,
            N, q, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_scan")
    _build.count_launch(ssd_scan)
    return y, state


ssd_scan.launches = 0
