"""``conv3d_valid``: the implicit-GEMM 3-D convolution kernel's wrapper,
and ``conv3d``, the convolution with its gradients.

On a CUDA tensor ``conv3d_valid`` checks what the kernel takes, plans
the launch (``plan``: the N tile, the K split and the gather width),
allocates the output and the kernel's scratch — the weight transposed to
(Cout, K), split into TF32 hi and lo parts for fp32, and for a split K
one fp32 partial sum per split — and launches ``csrc/conv3d.cu`` on the
current stream: the weight pass, the tiles and, for a split K, the sum
of the splits, counted as one launch in ``conv3d_valid.launches``.
Anything the kernel does not take raises. On a CPU tensor it runs the
plain version in ``ref.py``. No other path exists: there is no fallback
to the plain version, to ``F.conv3d`` or to cuDNN for a CUDA tensor.

``conv3d`` is ``conv3d_valid`` as a ``torch.autograd.Function``:

* the input gradient is itself a convolution, run by the same kernel
  (``conv3d_input_grad``, counted apart in its own ``launches``): dy,
  spread with zeros to stride 1 for a strided conv, convolved with the
  filter flipped in its three taps and transposed to (k, k, k, Cout,
  Cin), over pads (k-1-p, D+p-Do') that give back the input's shape;
* the weight gradient (``conv3d_weight_grad``) is im2col(x)ᵀ @ dy in
  fp32 (TF32 off), the (k³·Cin, Cout) result summed over every output
  voxel. The im2col is built a chunk at a time — whole samples where
  they fit, else runs of output depth planes of one sample — into a
  scratch of at most ``WGRAD_CHUNK_BYTES`` (the whole im2col of a 512³
  layer-0 input would take 58 GB); within a chunk, one batched
  product gives the partial sum of each block of ``WGRAD_ROWS`` voxels,
  and the partial sums are added in block, then chunk, order. (One
  product per tap instead would leave a (Cin, Cout) output, 4 x 16 at
  layer 0, too few tiles to fill the card, and read dy k³ times.)
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.conv3d import ref
from repro_torch.obs import trace as trace_lib
from repro_torch.kernels.conv3d.ref import NO_PADS, Pads

_ENTRY = {torch.float32: "conv3d_igemm_f32",
          torch.bfloat16: "conv3d_igemm_bf16",
          torch.float16: "conv3d_igemm_f16"}
_SIZE = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 18
             + [ctypes.c_void_p])
BM = 128                    # output voxels (GEMM rows) per block
ROW_BYTES = 128             # bytes of K per tile row and pipeline stage
N_TILES = (16, 32, 64, 128)  # output channels per block
MIN_SPLIT_STAGES = 2        # K stages a split takes at least
BOX_W = 16                  # the patch kernel's output box: 16 wide,
BOX_H = {4: 8, 2: 16}       # 8 (fp32) or 16 (16-bit types) high
PATCH_STAGES = (4, 3, 2)    # weight stages it may take, most first
SMEM_BLOCK = 232448         # shared memory a block may take
SMEM_SM = 233472            # shared memory of an SM (1 KB of it per block
                            # is the system's)
WGRAD_ROWS = 4096           # voxels a block of the weight gradient sums
WGRAD_CHUNK_BYTES = 2 ** 30  # the weight gradient's im2col scratch


@dataclass(frozen=True)
class Plan:
    """How one call is cut: ``bn`` output channels a block, K in
    ``k_tiles`` stages of ``ROW_BYTES``, ``tiles_per_split`` of them a
    block (``splits`` blocks share one output tile), the input gathered
    ``vec`` bytes a copy."""
    bn: int
    k_tiles: int
    tiles_per_split: int
    vec: int
    stages: int = 0         # > 0: the patch kernel, with this weight ring

    @property
    def splits(self) -> int:
        return -(-self.k_tiles // self.tiles_per_split)


def patch_smem(k: int, cin: int, bn: int, size: int, stages: int) -> int:
    """Shared memory of one patch-kernel block (``csrc/conv3d.cu``
    ``patch_layout``): the weight ring, the patch (chunk planes padded to
    16 bytes past a multiple of 128), 128 zero bytes, the K table and the
    barriers, from a 1024-byte aligned base."""
    ph, pw = BOX_H[size] + k - 1, BOX_W + k - 1
    plane = -(-(k * ph * pw * 16) // 128) * 128 + 16
    ring = stages * (2 if size == 4 else 1) * bn * ROW_BYTES
    body = ring + cin * size // 16 * plane
    k_cols = -(-(k ** 3 * cin) // (ROW_BYTES // size)) * (ROW_BYTES // size)
    bars = -(-(-(-body // 128) * 128 + 128 + 4 * k_cols) // 8) * 8
    return 1024 + bars + 8 * stages


def plan(x_shape, w_shape, out_shape, dtype: torch.dtype, sms: int,
         x_ptr: int = 0, stride: int = 1) -> Plan:
    """The launch for x of ``x_shape`` at address ``x_ptr`` on a card of
    ``sms`` SMs.

    The patch kernel takes stride 1 and taps of whole 16-byte chunks (a
    multiple of 16 channels in 16-bit types) where its output boxes fill
    the card; its weight ring is the deepest that leaves two blocks an SM,
    else the deepest that fits. Otherwise the gather kernel: K is split
    when the output tiles alone would leave SMs idle, into about
    ``sms / tiles`` parts of at least ``MIN_SPLIT_STAGES`` stages, and a
    gathered piece is the widest of 16, 8, 4, 2 bytes that divides both a
    tap's channel run (Cin * size) and the address, so it never straddles
    two taps."""
    size = _SIZE[dtype]
    k, cin, cout = w_shape[0], w_shape[3], w_shape[4]
    k_tiles = -(-(k ** 3 * cin) // (ROW_BYTES // size))
    bn = next((b for b in N_TILES if b >= cout), N_TILES[-1])
    vec = next(v for v in (16, 8, 4, 2)
               if (cin * size) % v == 0 and x_ptr % v == 0)
    n_tiles = -(-cout // bn)
    boxes = (out_shape[0] * out_shape[1] * -(-out_shape[2] // BOX_H[size])
             * -(-out_shape[3] // BOX_W))
    if (stride == 1 and vec == 16 and (size == 4 or cin % 16 == 0)
            and boxes * n_tiles >= sms):
        fits = [s for s in PATCH_STAGES
                if patch_smem(k, cin, bn, size, s) <= SMEM_BLOCK]
        two = [s for s in fits
               if 2 * (patch_smem(k, cin, bn, size, s) + 1024) <= SMEM_SM]
        if fits:
            return Plan(bn, k_tiles, k_tiles, vec, (two or fits)[0])
    tiles = -(-math.prod(out_shape[:4]) // BM) * n_tiles
    per_split = k_tiles
    if tiles < sms:
        per_split = max(MIN_SPLIT_STAGES, -(-k_tiles // -(-sms // tiles)))
    return Plan(bn, k_tiles, min(per_split, k_tiles), vec)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("conv3d"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, w: torch.Tensor, stride: int, pads: Pads):
    if x.device != w.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if x.dtype != w.dtype or x.dtype not in _ENTRY:
        raise TypeError(f"conv3d_valid takes x and w of one dtype among "
                        f"{sorted(str(d) for d in _ENTRY)}; got {x.dtype} "
                        f"and {w.dtype}")
    return _out_shape(x.shape, w.shape, stride, pads)


@functools.lru_cache(maxsize=4096)
def _out_shape(x_shape, w_shape, stride: int, pads: Pads):
    """The output shape, or what the kernel does not take (cached per
    shape: a call's host time counts against the kernel's)."""
    if len(x_shape) != 5 or len(w_shape) != 5:
        raise ValueError(f"x must be (N, D, H, W, Cin) and w (k, k, k, Cin, "
                         f"Cout); got {tuple(x_shape)} and {tuple(w_shape)}")
    k = w_shape[0]
    if w_shape[1] != k or w_shape[2] != k or w_shape[3] != x_shape[4]:
        raise ValueError(f"w {tuple(w_shape)} is not (k, k, k, Cin="
                         f"{x_shape[4]}, Cout)")
    if stride < 1 or len(pads) != 3 or any(p < 0 or q < 0 for p, q in pads):
        raise ValueError(f"stride {stride} / pads {pads} invalid")
    out = ref.output_shape(x_shape, w_shape, stride, pads)
    if min(out[1:4]) < 1:
        raise ValueError(f"input {tuple(x_shape)} with pads {pads} is "
                         f"smaller than the {k}^3 filter")
    # the kernel's 32-bit sizes: every dimension, the output voxels (GEMM
    # rows), K = k^3 * Cin, and the grid's Cout tiles
    if (max(x_shape[1:]) >= 2 ** 31 or math.prod(out[:4]) > 2 ** 31 - BM
            or k ** 3 * x_shape[4] >= 2 ** 31
            or -(-w_shape[4] // N_TILES[-1]) > 65535):
        raise ValueError("a dimension exceeds the kernel's 32-bit sizes")
    return out


@functools.lru_cache(maxsize=4096)
def _launch(x_shape, w_shape, out_shape, dtype, sms, x_align, stride):
    """The plan and the scratch buffer's layout: w_hi (Cout, Kp) in x's
    dtype, w_lo (fp32 only) and the splits' partial sums, each 256-byte
    aligned (offset, or None for a part the call has not)."""
    p = plan(x_shape, w_shape, out_shape, dtype, sms, x_align, stride)
    kp = -(-(w_shape[0] ** 3 * w_shape[3]) // 8) * 8
    cout = w_shape[4]
    parts = [cout * kp * _SIZE[dtype],
             cout * kp * 4 if dtype == torch.float32 else 0,
             p.splits * math.prod(out_shape) * 4 if p.splits > 1 else 0]
    sizes = [-(-b // 256) * 256 for b in parts]
    offsets = [sum(sizes[:i]) if parts[i] else None for i in range(3)]
    return p, sum(sizes), offsets


def conv3d_valid(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                 pads: Pads = NO_PADS) -> torch.Tensor:
    """VALID conv of the zero-padded input. x: (N, D, H, W, Cin)
    contiguous; w: (k, k, k, Cin, Cout) contiguous, same dtype; ``pads``
    the (lo, hi) zero padding of D, H, W, applied as bounds checks by the
    kernel. Output (N, Do, Ho, Wo, Cout) in x's dtype, accumulated in
    fp32 (fp32 products as 3xTF32 on the card)."""
    pads = tuple(tuple(int(v) for v in p) for p in pads)
    out_shape = _check(x, w, stride, pads)
    if x.device.type == "cpu":
        return ref.conv3d_valid(x, w, stride, pads)
    y = _run_kernel(x, w, stride, pads, out_shape)
    _build.count_launch(conv3d_valid)
    return y


conv3d_valid.launches = 0


def _run_kernel(x, w, stride, pads, out_shape) -> torch.Tensor:
    """Launch ``csrc/conv3d.cu`` for a checked call on the card."""
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_valid runs on CPU or CUDA tensors, not "
                         f"{x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3d_valid's kernel takes contiguous x and w")
    dev = x.device.index
    p, nbytes, offsets = _launch(x.shape, w.shape, out_shape, x.dtype,
                                 _sms(dev), x.data_ptr() & 15, stride)
    n, din, hin, win, cin = x.shape
    _, do, ho, wo, cout = out_shape
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    base = scratch.data_ptr()
    ptr = [None if o is None else base + o for o in offsets]
    with (contextlib.nullcontext() if torch.cuda.current_device() == dev
          else torch.cuda.device(dev)):
        err = _entry(x.dtype)(
            x.data_ptr(), w.data_ptr(), ptr[0], ptr[1], y.data_ptr(), ptr[2],
            n, din, hin, win, cin, do, ho, wo, cout, w.shape[0], stride,
            pads[0][0], pads[1][0], pads[2][0], p.bn, p.tiles_per_split,
            p.vec, p.stages, torch._C._cuda_getCurrentRawStream(dev))
    _build.check(err, "conv3d_igemm")
    return y


def conv3d_input_grad(dy: torch.Tensor, w: torch.Tensor, x_shape,
                      stride: int = 1, pads: Pads = NO_PADS) -> torch.Tensor:
    """dL/dx of ``conv3d_valid(x, w, stride, pads)`` for x of ``x_shape``,
    given dL/dy ``dy``, in dy's dtype: a stride-1 conv of dy (spread with
    zeros to stride 1 first when ``stride`` > 1) with the flipped,
    transposed filter, by the kernel on the card (one launch, counted in
    ``conv3d_input_grad.launches``) and by ``ref.py`` on the CPU."""
    k, s = w.shape[0], stride
    if s > 1:
        n, do, ho, wo, c = dy.shape
        spread = dy.new_zeros((n, (do - 1) * s + 1, (ho - 1) * s + 1,
                               (wo - 1) * s + 1, c))
        spread[:, ::s, ::s, ::s] = dy
        dy = spread
    dy = dy.contiguous()
    pads_t = tuple((k - 1 - int(p), int(x_shape[1 + d]) + int(p)
                    - dy.shape[1 + d])
                   for d, (p, _) in enumerate(pads))
    w_t = w.flip((0, 1, 2)).transpose(3, 4).contiguous()
    out_shape = _check(dy, w_t, 1, pads_t)
    if tuple(out_shape) != tuple(x_shape):
        raise ValueError(f"input gradient of shape {out_shape} for an input "
                         f"of {tuple(x_shape)}")
    if dy.device.type == "cpu":
        return ref.conv3d_valid(dy, w_t, 1, pads_t)
    dx = _run_kernel(dy, w_t, 1, pads_t, out_shape)
    _build.count_launch(conv3d_input_grad)
    return dx


conv3d_input_grad.launches = 0


@contextlib.contextmanager
def no_tf32():
    """fp32 matrix products in fp32 (TF32 off) inside the block; the
    weight gradient, the U-Net's up-convolution and head use it."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _row_blocks(m: int) -> int:
    """The number of equal blocks the weight gradient cuts ``m`` voxels
    into: the largest divisor of m that leaves blocks of at least
    ``WGRAD_ROWS`` rows (1 for fewer voxels)."""
    b = max(1, m // WGRAD_ROWS)
    while m % b:
        b -= 1
    return b


def conv3d_weight_grad(x: torch.Tensor, dy: torch.Tensor, w_shape,
                       stride: int = 1, pads: Pads = NO_PADS) -> torch.Tensor:
    """dL/dw of ``conv3d_valid(x, w, stride, pads)`` given dL/dy ``dy``,
    in fp32: im2col(x)ᵀ @ dy a chunk at a time (whole samples, or runs of
    output depth planes of one sample; the chunk's im2col copied to fp32
    in a scratch of at most ``WGRAD_CHUNK_BYTES``), each chunk by one
    batched fp32 product over blocks of voxels (TF32 off), the blocks'
    and chunks' partial sums added in order."""
    k, s = w_shape[0], stride
    cin, cout = w_shape[3], w_shape[4]
    n, do, ho, wo, _ = dy.shape
    cols = k ** 3 * cin
    (pd, qd), (ph, qh), (pw, qw) = pads
    xp = F.pad(x, (0, 0, pw, qw, ph, qh, pd, qd))
    plane = ho * wo * cols * 4              # scratch bytes a depth plane
    if do * plane <= WGRAD_CHUNK_BYTES:     # whole samples a chunk
        group = min(n, WGRAD_CHUNK_BYTES // (do * plane))
        chunks = [(i, min(n, i + group), 0, do) for i in range(0, n, group)]
    else:                                   # depth runs of one sample
        per = max(1, WGRAD_CHUNK_BYTES // plane)
        chunks = [(i, i + 1, d, min(do, d + per)) for i in range(n)
                  for d in range(0, do, per)]
    most = max((i1 - i0) * (d1 - d0) for i0, i1, d0, d1 in chunks)
    scratch = torch.empty((most * ho * wo, cols), dtype=torch.float32,
                          device=x.device)
    dw = torch.zeros((cols, cout), dtype=torch.float32, device=x.device)
    sn, sd, sh, sw, _ = xp.stride()
    with no_tf32():
        for i0, i1, d0, d1 in chunks:
            rows = (i1 - i0) * (d1 - d0) * ho * wo
            a = scratch[:rows]
            # every tap's window at once: a view of the padded x indexed
            # (sample, output voxel, kd, kh, kw, channel), copied in one go
            windows = xp.as_strided(
                (i1 - i0, d1 - d0, ho, wo, k, k, k, cin),
                (sn, s * sd, s * sh, s * sw, sd, sh, sw, 1),
                xp.storage_offset() + i0 * sn + d0 * s * sd)
            a.view(windows.shape).copy_(windows)
            blocks = _row_blocks(rows)
            g = dy[i0:i1, d0:d1].reshape(blocks, rows // blocks, cout).float()
            part = torch.bmm(a.view(blocks, rows // blocks, cols)
                             .transpose(1, 2), g)
            dw += part.sum(dim=0)
    return dw.view(tuple(w_shape))


class _Conv3d(torch.autograd.Function):
    """``conv3d_valid`` with the input gradient on the conv kernel
    (``conv3d_input_grad``) and the weight gradient in fp32 products
    (``conv3d_weight_grad``). The weight gradient comes first: its
    padded copy of x is freed before the input gradient's output is
    allocated, so the two are never held at once (at unet3d-256's
    ``dec0_w0`` each is 8.6 GB)."""

    @staticmethod
    def forward(ctx, x, w, stride, pads):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.pads = stride, pads
        return conv3d_valid(x, w, stride, pads)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dw = conv3d_weight_grad(x, dy.contiguous(), tuple(w.shape),
                                    ctx.stride, ctx.pads).to(w.dtype)
        if ctx.needs_input_grad[0]:
            trace_lib.instant("conv3d.input_grad")  # when, beside reductions
            dx = conv3d_input_grad(dy, w, tuple(x.shape), ctx.stride,
                                   ctx.pads)
        return dx, dw, None, None


def conv3d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           pads: Pads = NO_PADS) -> torch.Tensor:
    """``conv3d_valid`` with gradients: through ``_Conv3d`` where autograd
    records and x or w needs a gradient, else the forward alone."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        pads = tuple(tuple(int(v) for v in p) for p in pads)
        return _Conv3d.apply(x, w, stride, pads)
    return conv3d_valid(x, w, stride, pads)
