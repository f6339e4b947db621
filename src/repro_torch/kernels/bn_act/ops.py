"""``bn_leaky_relu``: the fused batch-norm + leaky-ReLU kernel's wrapper
(forward only).

On a CUDA tensor it checks what the kernel takes, allocates the output
and launches ``csrc/bn_act.cu`` on the current stream, adding one to
``bn_leaky_relu.launches``; anything the kernel does not take raises. On
a CPU tensor it runs the plain version in ``ref.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bn_act import ref

_ENTRY = {torch.float32: "bn_act_f32",
          torch.bfloat16: "bn_act_bf16",
          torch.float16: "bn_act_f16"}
_MAX_C = 4096  # three fp32 (C,) vectors in 48 KB of shared memory


def _entry(dtype: torch.dtype):
    fn = getattr(_build.load("bn_act"), _ENTRY[dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6
                       + [ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def bn_leaky_relu(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                  scale: torch.Tensor, bias: torch.Tensor, *,
                  eps: float = 1e-5,
                  negative_slope: float = 0.01) -> torch.Tensor:
    """x: (..., C) contiguous; mean/var/scale/bias: (C,), any float
    dtype (taken as fp32, as the reference kernel does). Output in x's
    dtype."""
    if x.dtype not in _ENTRY:
        raise TypeError(f"bn_leaky_relu takes x among "
                        f"{sorted(str(d) for d in _ENTRY)}; got {x.dtype}")
    c = x.shape[-1] if x.dim() else 0
    for name, v in (("mean", mean), ("var", var), ("scale", scale),
                    ("bias", bias)):
        if v.shape != (c,) or v.device != x.device:
            raise ValueError(f"{name} must be ({c},) on {x.device}; got "
                             f"{tuple(v.shape)} on {v.device}")
        if not v.is_floating_point():
            raise TypeError(f"{name} must be floating point; got {v.dtype}")
    if x.device.type == "cpu":
        return ref.bn_leaky_relu(x, mean, var, scale, bias, eps=eps,
                                 negative_slope=negative_slope)
    if x.device.type != "cuda":
        raise ValueError(f"bn_leaky_relu runs on CPU or CUDA tensors, not "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("bn_leaky_relu's kernel takes a contiguous x")
    if not 1 <= c <= _MAX_C:
        raise ValueError(f"channel count {c} outside the kernel's "
                         f"[1, {_MAX_C}]")
    vecs = [v.float().contiguous() for v in (mean, var, scale, bias)]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _entry(x.dtype)(
            x.data_ptr(), *(v.data_ptr() for v in vecs), y.data_ptr(),
            x.numel() // c, c, float(eps), float(negative_slope),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "bn_act")
    _build.count_launch(bn_leaky_relu)
    return y


bn_leaky_relu.launches = 0
