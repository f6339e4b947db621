"""``pack`` / ``unpack``: the halo pack and unpack kernels' wrappers.

On a CUDA tensor each checks what its kernel takes, allocates the output
and launches ``csrc/halo_pack.cu`` on the current stream, adding one to
``pack.launches`` / ``unpack.launches``; anything the kernel does not
take raises. On a CPU tensor each runs its plain version in ``ref.py``.
There is no fallback to the plain version or to ``torch.cat`` for a CUDA
tensor.

Both go through ONE copy engine, ``halo_copy``. ``parts`` lays a call out
as 2 (pack) or 3 (unpack) parts, each one contiguous run a sample;
``split`` cuts every run into chunks over one flat index, one block a
chunk, and picks the 16-byte vectors a thread (so the chunk) from the
launch's total bytes (the header of ``csrc/halo_pack.cu``). The kernel
receives ``parts`` and ``split`` as they are; both, and the C array the
kernel reads them from, are kept per launch shape (``_launch``), so a
call on the sharded paths does no more host work than a launch. Tests
hold one vector count by patching ``REG_VECTORS`` (and
``REG_STREAM_BYTES`` above the launch); the cache keys on both.

Both carry gradients where autograd records (the reference has no
backward kernel for either; it trains through XLA): pack's adjoint adds
the two face gradients into the trailing ``lo`` and leading ``hi``
depth rows of a zero dx (PyTorch slicing and adds); unpack's splits the
padded gradient into d_lo, d_x (a view) and d_hi, its two faces by ONE
launch of the pack kernel, whose faces they are with the widths swapped
(the trailing ``hi`` rows, the leading ``lo`` rows), counted in
``pack.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.halo_pack import ref
from repro_torch.kernels.halo_pack.ref import PackedFaces

REG_THREADS = 256              # threads a block (kThreads in the source)
REG_VECTORS = (4, 2, 1)        # 16-byte vectors a thread, widest first
# a launch reading at least this many bytes streams past the 50 MB L2:
# one vector a thread (4 KB chunks) was ~1.3% faster there on an H100
REG_STREAM_BYTES = 64 << 20


class Part(NamedTuple):
    """One run a sample: ``bytes`` from ``src_offset + s * src_stride``
    of the part's source to ``dst_offset + s * dst_stride`` of the
    output, for each sample s (offsets in bytes)."""

    src_offset: int
    src_stride: int
    dst_offset: int
    dst_stride: int
    bytes: int


class Split(NamedTuple):
    """How one launch cuts its work: the kernel's arguments. One block a
    chunk, so the grid is ``total``."""

    vectors: int               # 16-byte vectors a thread
    chunk: int                 # bytes a chunk: vectors * REG_THREADS * 16
    chunks: Tuple[int, ...]    # chunks of each part's run of one sample
    total: int                 # chunks of the launch, over one index


def parts(kind: str, n: int, d: int, row: int, lo: int,
          hi: int) -> Tuple[Part, ...]:
    """The runs of a ``pack`` (to_next, to_prev: both read x) or an
    ``unpack`` (lo_buf, x, hi_buf) of N samples of D depth rows of
    ``row`` bytes; a width of 0 gives a part of 0 bytes."""
    if kind == "pack":
        return (Part((d - lo) * row, d * row, 0, lo * row, lo * row),
                Part(0, d * row, n * lo * row, hi * row, hi * row))
    pad = (lo + d + hi) * row
    return (Part(0, lo * row, 0, pad, lo * row),
            Part(0, d * row, lo * row, pad, d * row),
            Part(0, hi * row, (lo + d) * row, pad, hi * row))


def split(ps: Sequence[Part], n: int, sms: int) -> Split:
    """The widest ``REG_VECTORS`` whose chunks still give every SM a
    block, or one vector a thread from ``REG_STREAM_BYTES`` on."""
    work = n * sum(p.bytes for p in ps)
    for v in (1,) if work >= REG_STREAM_BYTES else REG_VECTORS:
        chunk = v * REG_THREADS * 16
        chunks = tuple(-(-p.bytes // chunk) for p in ps)
        total = n * sum(chunks)
        if total >= sms:
            break
    return Split(v, chunk, chunks, total)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=4096)
def _launch(kind: str, n: int, d: int, row: int, lo: int, hi: int,
            sms: int, vectors: Tuple[int, ...], stream_bytes: int):
    """(split, C array of the parts) of one launch shape; ``vectors`` and
    ``stream_bytes`` are the constants ``split`` reads, in the key so
    that a patch of them is seen."""
    ps = parts(kind, n, d, row, lo, hi)
    geom = [v for p in ps for v in p] + [0] * (5 * (3 - len(ps)))
    return split(ps, n, sms), (ctypes.c_longlong * 15)(*geom)


def _copy(srcs, dst: torch.Tensor, kind: str, n: int, d: int, row: int,
          lo: int, hi: int) -> None:
    """ONE launch of ``halo_copy`` on dst's current stream."""
    index = dst.device.index
    if torch.cuda.current_device() != index:
        with torch.cuda.device(index):
            return _copy(srcs, dst, kind, n, d, row, lo, hi)
    sp, geom = _launch(kind, n, d, row, lo, hi, _sms(index), REG_VECTORS,
                       REG_STREAM_BYTES)
    ptrs = [None if t is None else t.data_ptr() for t in srcs]
    ptrs += [None] * (3 - len(ptrs))
    err = _entry()(*ptrs, dst.data_ptr(), geom, n, sp.chunk, sp.total,
                   sp.vectors, torch.cuda.current_stream(index).cuda_stream)
    _build.check(err, f"halo_{kind}")


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("halo_pack").halo_copy
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
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


def _records(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def pack(x: torch.Tensor, lo: int, hi: int) -> PackedFaces:
    """x: (N, D, H, W, C) contiguous -> ONE buffer holding its trailing
    ``lo`` depth rows (``to_next``) then its leading ``hi`` rows
    (``to_prev``), each part contiguous; 0 <= lo, hi <= D."""
    _check_x(x, "pack")
    lo, hi = int(lo), int(hi)
    if not (0 <= lo <= x.shape[1] and 0 <= hi <= x.shape[1]):
        raise ValueError(f"pack widths lo={lo}, hi={hi} outside [0, D="
                         f"{x.shape[1]}]")
    buf = _Pack.apply(x, lo, hi) if _records(x) else _pack(x, lo, hi)
    return ref.faces(buf, x.shape, lo, hi)


def _pack(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """The pack buffer: the plain version on the CPU, else one launch."""
    if x.device.type == "cpu":
        return ref.pack(x, lo, hi).buf
    if not x.is_contiguous():
        raise ValueError("pack's kernel takes a contiguous x")
    n, d = x.shape[:2]
    buf = torch.empty(n * (lo + hi) * math.prod(x.shape[2:]),
                      dtype=x.dtype, device=x.device)
    _copy((x, x), buf, "pack", n, d, _row_bytes(x), lo, hi)
    _build.count_launch(pack)
    return buf


class _Pack(torch.autograd.Function):
    """``pack`` with its adjoint: the face gradients added into the rows
    they came from."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.shape, ctx.lo, ctx.hi = x.shape, lo, hi
        return _pack(x, lo, hi)

    @staticmethod
    def backward(ctx, dbuf):
        lo, hi = ctx.lo, ctx.hi
        d = ctx.shape[1]
        faces = ref.faces(dbuf, ctx.shape, lo, hi)
        dx = dbuf.new_zeros(ctx.shape)
        if lo:
            dx.narrow(1, d - lo, lo).add_(faces.to_next)
        if hi:
            dx.narrow(1, 0, hi).add_(faces.to_prev)
        return dx, None, None


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
    if _records(x, lo_buf, hi_buf):
        return _Unpack.apply(x, lo_buf, hi_buf)
    return _unpack(x, lo_buf, hi_buf)


def _unpack(x: torch.Tensor, lo_buf: Optional[torch.Tensor],
            hi_buf: Optional[torch.Tensor]) -> torch.Tensor:
    """The padded buffer: the plain version on the CPU, else one
    launch."""
    if x.device.type == "cpu":
        return ref.unpack(x, lo_buf, hi_buf)
    n, d = x.shape[:2]
    if not all(t.is_contiguous() for t in (lo_buf, x, hi_buf)
               if t is not None):
        raise ValueError("unpack's kernel takes contiguous x, lo_buf and "
                         "hi_buf")
    lo = 0 if lo_buf is None else lo_buf.shape[1]
    hi = 0 if hi_buf is None else hi_buf.shape[1]
    out = torch.empty((n, lo + d + hi) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    _copy((lo_buf, x, hi_buf), out, "unpack", n, d, _row_bytes(x), lo, hi)
    _build.count_launch(unpack)
    return out


class _Unpack(torch.autograd.Function):
    """``unpack`` with its adjoint: d_x a view of the padded gradient,
    d_lo and d_hi its leading ``lo`` and trailing ``hi`` rows, both out
    of one ``pack`` of it with the widths swapped."""

    @staticmethod
    def forward(ctx, x, lo_buf, hi_buf):
        ctx.lo = 0 if lo_buf is None else lo_buf.shape[1]
        ctx.hi = 0 if hi_buf is None else hi_buf.shape[1]
        ctx.d = x.shape[1]
        return _unpack(x, lo_buf, hi_buf)

    @staticmethod
    def backward(ctx, dout):
        lo, hi = ctx.lo, ctx.hi
        faces = pack(dout.contiguous(), hi, lo)
        return dout.narrow(1, lo, ctx.d), faces.to_prev, faces.to_next


pack.launches = 0
unpack.launches = 0
