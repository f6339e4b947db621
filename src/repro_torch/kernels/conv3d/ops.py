"""``conv3d_valid``: the direct 3-D convolution kernel's wrapper.

On a CUDA tensor it checks what the kernel takes, allocates the output
and launches ``csrc/conv3d.cu`` on the current stream, adding one to
``conv3d_valid.launches``; anything the kernel does not take raises. On
a CPU tensor it runs the plain version in ``ref.py``. No other path
exists: there is no fallback to the plain version, to ``F.conv3d`` or
to cuDNN for a CUDA tensor.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv3d import ref
from repro_torch.kernels.conv3d.ref import NO_PADS, Pads

_ENTRY = {torch.float32: "conv3d_direct_f32",
          torch.bfloat16: "conv3d_direct_bf16",
          torch.float16: "conv3d_direct_f16"}
_COUT_TILE = 16
_MAX_SMEM = 48 * 1024


def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("conv3d"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 14
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, w: torch.Tensor, stride: int, pads: Pads):
    if x.device != w.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if x.dtype != w.dtype or x.dtype not in _ENTRY:
        raise TypeError(f"conv3d_valid takes x and w of one dtype among "
                        f"{sorted(str(d) for d in _ENTRY)}; got {x.dtype} "
                        f"and {w.dtype}")
    if x.dim() != 5 or w.dim() != 5:
        raise ValueError(f"x must be (N, D, H, W, Cin) and w (k, k, k, Cin, "
                         f"Cout); got {tuple(x.shape)} and {tuple(w.shape)}")
    k = w.shape[0]
    if w.shape[1] != k or w.shape[2] != k or w.shape[3] != x.shape[4]:
        raise ValueError(f"w {tuple(w.shape)} is not (k, k, k, Cin="
                         f"{x.shape[4]}, Cout)")
    if k ** 3 * _COUT_TILE * 4 > _MAX_SMEM:
        raise ValueError(f"kernel size {k} exceeds the kernel's staged "
                         f"weight tile")
    if stride < 1 or len(pads) != 3 or any(p < 0 or q < 0 for p, q in pads):
        raise ValueError(f"stride {stride} / pads {pads} invalid")
    out = ref.output_shape(x.shape, w.shape, stride, pads)
    if min(out[1:4]) < 1:
        raise ValueError(f"input {tuple(x.shape)} with pads {pads} is "
                         f"smaller than the {k}^3 filter")
    if max(x.shape[1:]) >= 2 ** 31 or max(out) >= 2 ** 31:
        raise ValueError("a dimension exceeds the kernel's 32-bit sizes")
    return out


def conv3d_valid(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                 pads: Pads = NO_PADS) -> torch.Tensor:
    """VALID conv of the zero-padded input. x: (N, D, H, W, Cin)
    contiguous; w: (k, k, k, Cin, Cout) contiguous, same dtype; ``pads``
    the (lo, hi) zero padding of D, H, W, applied as bounds checks by the
    kernel. Output (N, Do, Ho, Wo, Cout) in x's dtype, accumulated in
    fp32."""
    pads = tuple(tuple(int(v) for v in p) for p in pads)
    out_shape = _check(x, w, stride, pads)
    if x.device.type == "cpu":
        return ref.conv3d_valid(x, w, stride, pads)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_valid runs on CPU or CUDA tensors, not "
                         f"{x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3d_valid's kernel takes contiguous x and w")
    y = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    n, din, hin, win, cin = x.shape
    _, do, ho, wo, cout = out_shape
    with torch.cuda.device(x.device):
        err = _entry(x.dtype)(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), n, din, hin, win, cin,
            do, ho, wo, cout, w.shape[0], stride, pads[0][0], pads[1][0],
            pads[2][0], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "conv3d_direct")
    _build.count_launch(conv3d_valid)
    return y


conv3d_valid.launches = 0
