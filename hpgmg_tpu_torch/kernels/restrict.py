"""K3: the 8->1 cell restriction (counterpart of hpgmg_tpu/kernels/restrict.py).

``restrict_cell`` dispatches on the device: CUDA tensors launch
``csrc/restrict.cu`` (one thread per coarse cell, all three axes in one
pass), CPU tensors take ``restrict_cell_plain``, the 2x2x2 mean. Both take
any block with even extents: a level's cube, or one rank's local block of
a decomposed level; in float32, float64 or bfloat16 (summed in float32,
rounded to bf16 once; the kernel's bf16 launches count in
``restrict_cell_cuda.bf16_launches``).
"""

from __future__ import annotations

import torch

_ENTRIES = {torch.float32: "hpgmg_restrict_cell_f32",
            torch.float64: "hpgmg_restrict_cell_f64",
            torch.bfloat16: "hpgmg_restrict_cell_bf16"}


def _check(x: torch.Tensor):
    """The coarse shape of ``x``; raise on what the kernel does not take."""
    if x.dim() != 3:
        raise ValueError(f"restrict_cell wants a 3-D block, got {tuple(x.shape)}")
    if any(n % 2 or n < 2 for n in x.shape):
        raise ValueError(f"restrict_cell wants even extents, got {tuple(x.shape)}")
    if x.dtype not in _ENTRIES:
        raise TypeError(f"restrict_cell takes float32/float64/bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("restrict_cell wants a contiguous tensor")
    return tuple(n // 2 for n in x.shape)


def restrict_cell_plain(x: torch.Tensor) -> torch.Tensor:
    """Piecewise-constant 8->1 cell average in plain PyTorch (bfloat16
    widened to float32, the mean rounded back once)."""
    mi, mj, mk = _check(x)
    restrict_cell_plain.calls += 1
    wide = x.float() if x.dtype == torch.bfloat16 else x
    return wide.view(mi, 2, mj, 2, mk, 2).mean(dim=(1, 3, 5)).to(x.dtype)


restrict_cell_plain.calls = 0


def restrict_cell_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the K3 kernel on ``x`` (a CUDA tensor) into a new tensor."""
    from hpgmg_tpu_torch.kernels.build import library

    m = _check(x)
    if not x.is_cuda:
        raise ValueError(f"restrict_cell_cuda wants a CUDA tensor, got {x.device}")
    out = torch.empty(m, dtype=x.dtype, device=x.device)
    fn = getattr(library(), _ENTRIES[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), *m, stream)
    if rc != 0:
        raise RuntimeError(f"restrict_cell kernel launch failed: CUDA error {rc}")
    if x.dtype == torch.bfloat16:
        restrict_cell_cuda.bf16_launches += 1
    else:
        restrict_cell_cuda.launches += 1
    return out


restrict_cell_cuda.launches = 0
restrict_cell_cuda.bf16_launches = 0


def restrict_cell(x: torch.Tensor) -> torch.Tensor:
    """(ni, nj, nk) -> (ni/2, nj/2, nk/2): each coarse cell the mean of its
    8 children (restriction.c:6-94)."""
    if x.is_cuda:
        return restrict_cell_cuda(x)
    if x.device.type == "cpu":
        return restrict_cell_plain(x)
    raise ValueError(f"restrict_cell has no kernel for device {x.device}")
