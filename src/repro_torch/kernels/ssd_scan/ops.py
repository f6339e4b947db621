"""``ssd_scan``: the SSD chunked-scan kernel's wrapper, an autograd
``Function`` (``SSDScan``).

Forward. On a CUDA tensor it checks what the kernel takes, allocates
``y``, the final state and the kernel's scratch (one fp32 (P, N) state
per chunk and head, each chunk's summed decay exponent, and each
chunk's fp32 C Bᵀ), and launches ``csrc/ssd_scan.cu`` on the current
stream (three CUDA launches), adding one to ``ssd_scan.launches``;
anything the kernel does not take raises. x, Bm and Cm are read in
place: views whose last dimension is contiguous (and x's heads packed
at P), with Bm and Cm at one stride, as the Mamba2 block's split of its
conv output gives them (``kernel_strides``). On a CPU tensor it runs
the plain version in ``ref.py``.

Backward. The reference's Pallas kernel has no backward: the reference
block calls the plain chunked scan and ``jax.grad`` differentiates that.
So the backward takes the same gradient: it saves only the inputs (the
views as they are), recomputes ``ref.ssd_chunked`` at the kernel's
chunk (``chunk_len``) under ``torch.enable_grad`` and returns its
``autograd.grad`` for x, dt, A, Bm and Cm against the incoming
gradients of y and of the final state. One call's recompute is alive at
a time (the Mamba2 blocks' backwards run one after another). It
launches no kernel and counts nothing; on both devices it is the same
code.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import ref

_ENTRY = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
# the chunk-state blocks keep two heads' cumulative decays, steps and
# weights (6 * Q fp32) beside 72 KB of tiles in shared memory (172 KB at
# Q = 4096, of 227), and the C Bᵀ scratch is Q * L fp32 a sequence
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
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int64] * 2
                       + [ctypes.c_int] * 4 + [ctypes.c_int64] * 4
                       + [ctypes.c_void_p])
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


def _rows(v: torch.Tensor, name: str) -> Tuple[int, int]:
    """(batch stride, row stride) of ``v`` (B, L, ...) whose trailing
    dimensions are packed as in a contiguous tensor; raises otherwise.
    The kernel only reads these, so any row and batch strides do; a
    size-1 dimension's stride does not matter."""
    inner = v.shape[2:]
    step = 1
    for size, stride in zip(reversed(inner), reversed(v.stride()[2:])):
        if size > 1 and stride != step:
            raise ValueError(f"ssd_scan's kernel takes a contiguous {name}, "
                             f"or a view of rows of it; got strides "
                             f"{v.stride()}")
        step *= size
    Bb, L = v.shape[:2]
    row = v.stride(1) if L > 1 else step
    return (v.stride(0) if Bb > 1 else L * row), row


def kernel_strides(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor
                   ) -> Tuple[int, int, int, int]:
    """(x's batch and row strides, Bm's and Cm's batch and row strides),
    in elements, for the kernel: x (B, L, H, P) with (H, P) packed, Bm
    and Cm (B, L, N) with N contiguous and one stride for both. Raises
    ``ValueError`` ("... contiguous x" / "... contiguous Cm") on any
    other layout."""
    xb, xl = _rows(x, "x")
    bb, bl = _rows(Bm, "Bm")
    if _rows(Cm, "Cm") != (bb, bl):
        raise ValueError(f"ssd_scan's kernel takes a contiguous Cm, or Bm "
                         f"and Cm at one stride; got {Bm.stride()} and "
                         f"{Cm.stride()}")
    return xb, xl, bb, bl


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, H, P); dt: (B, L, H) post-softplus; A: (H,) negative;
    Bm/Cm: (B, L, N), one group shared by every head (for the kernel,
    views at the layouts ``kernel_strides`` takes). Returns y
    (B, L, H, P) in x's dtype and the final state (B, H, P, N) in fp32,
    both differentiable (``SSDScan``). The kernel works in chunks of
    ``chunk_len(L, chunk)`` steps; the plain version is sequential."""
    chunk = int(chunk)
    _check(x, dt, A, Bm, Cm, chunk)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on CPU or CUDA tensors, not "
                         f"{x.device}")
    return SSDScan.apply(x, dt, A, Bm, Cm, chunk)


class SSDScan(torch.autograd.Function):
    """The kernel (or, on the CPU, the sequential plain version) forward;
    the reference's chunked-scan gradient backward (module docstring)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.set_materialize_grads(False)
        if x.device.type == "cpu":
            return ref.ssd_scan(x, dt, A, Bm, Cm)
        return _launch(x, dt, A, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        inputs = ctx.saved_tensors
        need = ctx.needs_input_grad[:5]
        given = [(o, g) for o, g in ((0, gy), (1, gstate)) if g is not None]
        if not given:
            return (None,) * 6
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(inputs, need)]
            y, extras = ref.ssd_chunked(
                *leaves, chunk=chunk_len(inputs[0].shape[1], ctx.chunk))
            outs = (y, extras.final_state)
            got = iter(torch.autograd.grad(
                [outs[i] for i, _ in given], [t for t in leaves
                                              if t.requires_grad],
                [g for _, g in given], allow_unused=True))
        return tuple(next(got) if n else None for n in need) + (None,)


def _launch(x, dt, A, Bm, Cm, chunk: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors: checks, scratch, three launches on the
    current stream, one count on ``ssd_scan``."""
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
    for name, v in (("dt", dt), ("A", A)):
        if not v.is_contiguous():
            raise ValueError(f"ssd_scan's kernel takes a contiguous {name}")
    strides = kernel_strides(x, Bm, Cm)
    Bb, L, H, P = x.shape
    N = Bm.shape[-1]
    q = chunk_len(L, chunk)
    if q > MAX_CHUNK:
        raise ValueError(f"chunk {q} above the kernel's {MAX_CHUNK}")
    nc = L // q
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    state = torch.empty((Bb, H, P, N), **f32)
    chunk_states = torch.empty((Bb, nc, H, P, N), **f32)
    chunk_decay = torch.empty((Bb, nc, H), **f32)
    cb = torch.empty((Bb, nc, q, q), **f32)
    with torch.cuda.device(x.device):
        err = _entry(x.dtype)(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), state.data_ptr(),
            chunk_states.data_ptr(), chunk_decay.data_ptr(), cb.data_ptr(),
            Bb, L, H, P, N, q, *strides,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "ssd_scan")
    _build.count_launch(ssd_scan)
    return y, state


ssd_scan.launches = 0
