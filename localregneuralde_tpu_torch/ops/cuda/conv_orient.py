"""One 3×3 SAME convolution in the two layouts of the conv-orientation
probe (kernel 15).

Counterpart of ``scripts/conv_orient_probe.py::conv_pallas_tap`` and
``::conv_pallas_im2col``: an NHWC batch ``x`` (B, H, W, Cin), read as the
flat (B·H·W, Cin) matrix, convolved with an HWIO weight (3, 3, Cin, Cout).
``conv_orient_tap`` sums nine shifted products with the border masks folded
into the accumulate; ``conv_orient_im2col`` loads each tap's tile with the
image border zero-filled, so its products need no mask. Both run on the
tensor cores (``csrc/conv_orient.cu``: TMA tiles into ``wgmma``, FP32
accuracy as 3xTF32). They lie on no model path: ``chip_smoke.py`` times
them beside the CIFAR kernels' implicit GEMM and cuDNN.

The plain version is ``nn.basic.conv2d_nhwc`` in FP32 (the package turns
cuDNN's TF32 off), which is also the one PyTorch call computing the same
function. On a CPU tensor the wrappers run it.
"""
from __future__ import annotations

import torch

from ...nn.basic import conv2d_nhwc
from . import _build


def conv_orient_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version of both kernels: ``conv2d_nhwc``."""
    return conv2d_nhwc(x, w)


def _check(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """Validate the operands: float32, contiguous, on one device, x
    (B, H, W, Cin) and w (3, 3, Cin, Cout), fewer than 2**31 pixels.
    Returns (B, H, W, Cin, Cout)."""
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)}: expected "
                         "(B, H, W, Cin) and (3, 3, Cin, Cout)")
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous float32")
        if t.device != x.device:
            raise ValueError(f"{name}: on {t.device}, x on {x.device}")
    if x.numel() == 0 or w.numel() == 0:
        raise ValueError("empty input")
    if x.shape[0] * x.shape[1] * x.shape[2] >= 2**31:
        raise ValueError(f"x {tuple(x.shape)}: the kernels index pixels in "
                         "32 bits")
    return (*x.shape, w.shape[3])


def _launch(entry: str, fn, x, w) -> torch.Tensor:
    B, H, W, cin, cout = _check(x, w)
    lib = _build.load_library()
    out = torch.empty((B, H, W, cout), device=x.device)
    p = _build.ptr
    err = getattr(lib, entry)(p(x), p(w), p(out), B, H, W, cin, cout,
                              _build.stream_ptr(x.device))
    _build.check(lib, err, fn.__name__)
    fn.launches += 1
    return out


def conv_orient_tap(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The tap layout: nine shifted (M, Cin) @ (Cin, Cout) products, each
    masked at the image border in the accumulate. A CUDA tensor launches
    the kernel; a CPU tensor runs ``conv_orient_plain``."""
    if x.device.type == "cpu":
        return conv_orient_plain(x, w)
    return _launch("lrnde_conv_orient_tap", conv_orient_tap, x, w)


def conv_orient_im2col(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The im2col layout: the taps' tiles zero-filled outside the image, no
    mask in the accumulate. A CUDA tensor launches the kernel; a CPU tensor
    runs ``conv_orient_plain``."""
    if x.device.type == "cpu":
        return conv_orient_plain(x, w)
    return _launch("lrnde_conv_orient_im2col", conv_orient_im2col, x, w)


conv_orient_tap.launches = 0
conv_orient_im2col.launches = 0
