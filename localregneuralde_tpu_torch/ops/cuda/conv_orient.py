"""One 3×3 SAME convolution in the two layouts of the conv-orientation
probe (kernel 15).

Counterpart of ``scripts/conv_orient_probe.py::conv_pallas_tap`` and
``::conv_pallas_im2col``: an NHWC batch ``x`` (B, H, W, Cin), read as the
flat (B·H·W, Cin) matrix, convolved with an HWIO weight (3, 3, Cin, Cout).
``conv_orient_tap`` sums nine shifted products with the border masks folded
into the accumulate; ``conv_orient_im2col`` gathers the masked im2col tile
of a block of pixels into shared memory and runs one product
(``csrc/conv_orient.cu``). They lie on no model path: ``chip_smoke.py``
times them beside the CIFAR kernels' implicit GEMM and cuDNN.

The plain version is ``nn.basic.conv2d_nhwc`` in FP32 (the package turns
cuDNN's TF32 off), which is also the one PyTorch call computing the same
function. On a CPU tensor the wrappers run it.
"""
from __future__ import annotations

import torch

from ...nn.basic import conv2d_nhwc
from . import _build
from .fused_solve import CHAIN_SMEM_BYTES

# the im2col tile of a CTA (csrc/conv_orient.cu::kColRows pixels by 9·Cin)
# sits in dynamic shared memory beside a 4 KB weight chunk
IM2COL_SMEM_BYTES = CHAIN_SMEM_BYTES - 4096


def conv_orient_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version of both kernels: ``conv2d_nhwc``."""
    return conv2d_nhwc(x, w)


def _check(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """Validate the operands: float32, contiguous, on one device, x
    (B, H, W, Cin) and w (3, 3, Cin, Cout). Returns (B, H, W, Cin, Cout)."""
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)}: expected "
                         "(B, H, W, Cin) and (3, 3, Cin, Cout)")
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous float32")
        if t.device != x.device:
            raise ValueError(f"{name}: on {t.device}, x on {x.device}")
    if x.numel() == 0:
        raise ValueError("empty input")
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
    masked at the image border. A CUDA tensor launches the kernel; a CPU
    tensor runs ``conv_orient_plain``."""
    if x.device.type == "cpu":
        return conv_orient_plain(x, w)
    return _launch("lrnde_conv_orient_tap", conv_orient_tap, x, w)


def conv_orient_im2col(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The im2col layout: a masked (64, 9·Cin) gather per block of pixels,
    then one product. A CUDA tensor launches the kernel (its tile must fit
    in ``IM2COL_SMEM_BYTES``: Cin ≤ 90); a CPU tensor runs
    ``conv_orient_plain``."""
    if x.device.type == "cpu":
        return conv_orient_plain(x, w)
    need = 4 * _build.load_library().lrnde_conv_orient_im2col_smem_floats(
        x.shape[-1])
    if need > IM2COL_SMEM_BYTES:
        raise ValueError(f"Cin = {x.shape[-1]}: the im2col tile needs {need} "
                         f"bytes of shared memory, at most {IM2COL_SMEM_BYTES}")
    return _launch("lrnde_conv_orient_im2col", conv_orient_im2col, x, w)


conv_orient_tap.launches = 0
conv_orient_im2col.launches = 0
