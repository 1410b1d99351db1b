"""The launch count of every kernel wrapper and the call count of every
plain version, read and reset together: how a run shows which kernels its
path went through (chip_smoke.py, bench/weak.py)."""

from __future__ import annotations

from typing import Dict, Tuple

# (name, module, wrapper, attribute) of every kernel's launch count; the
# stencil wrappers count their periodic launches (K7a, K7b) apart, the
# slab kernels (K8a-K8d) their launches on blocks split along k (k slabs),
# the kernels with a bfloat16 instantiation their bf16 launches (the
# stencil wrappers their periodic bf16 launches apart again, the slab
# kernels their bf16 launches with k slabs; K1 also its BF16C gsrb
# launches: float32 x, bf16 coefficients); fv4_small counts
# the fv4 suite's calls on levels below 4^3, which every device computes
# by the plain version (stencils.small_level)
KERNELS = (
    ("fv4_stencil", "stencils", "fv4_stencil_cuda", "launches"),
    ("fv4_subtile", "stencils", "fv4_subtile_cuda", "launches"),
    ("fv4_stencil_periodic", "stencils", "fv4_stencil_cuda", "periodic_launches"),
    ("fv4_gsrb2", "stencils", "fv4_gsrb2_cuda", "launches"),
    ("fv4_gsrb2_cluster", "stencils", "fv4_gsrb2_cluster_cuda", "launches"),
    ("fv4_slab", "stencils", "fv4_slab_cuda", "launches"),
    ("fv4_overlap_interior", "stencils", "fv4_overlap_interior_cuda", "launches"),
    ("fv4_overlap_edge", "stencils", "fv4_overlap_edge_cuda", "launches"),
    ("tail_down", "tail", "tail_down_cuda", "launches"),
    ("tail_up", "tail", "tail_up_cuda", "launches"),
    ("tail_v", "tail", "tail_v_cuda", "launches"),
    ("restrict_cell", "restrict", "restrict_cell_cuda", "launches"),
    ("r1_stencil", "stencils_r1", "r1_stencil_cuda", "launches"),
    ("r1_stencil_periodic", "stencils_r1", "r1_stencil_cuda", "periodic_launches"),
    ("r1_stream", "stencils_r1", "r1_stream_cuda", "launches"),
    ("r1_stream_periodic", "stencils_r1", "r1_stream_cuda", "periodic_launches"),
    ("r1_gsrb2", "stencils_r1", "r1_gsrb2_cuda", "launches"),
    ("r1_slab", "stencils_r1", "r1_slab_cuda", "launches"),
    ("r1_gsrb2_slab", "stencils_r1", "r1_gsrb2_slab_cuda", "launches"),
    ("fv4_slab_kslab", "stencils", "fv4_slab_cuda", "kslab_launches"),
    ("fv4_overlap_interior_kslab", "stencils", "fv4_overlap_interior_cuda",
     "kslab_launches"),
    ("fv4_overlap_edge_kslab", "stencils", "fv4_overlap_edge_cuda", "kslab_launches"),
    ("r1_slab_kslab", "stencils_r1", "r1_slab_cuda", "kslab_launches"),
    ("r1_gsrb2_slab_kslab", "stencils_r1", "r1_gsrb2_slab_cuda", "kslab_launches"),
    ("fv4_stencil_bf16", "stencils", "fv4_stencil_cuda", "bf16_launches"),
    ("fv4_stencil_bf16c", "stencils", "fv4_stencil_cuda", "bf16c_launches"),
    ("fv4_subtile_bf16", "stencils", "fv4_subtile_cuda", "bf16_launches"),
    ("fv4_gsrb2_cluster_bf16", "stencils", "fv4_gsrb2_cluster_cuda", "bf16_launches"),
    ("restrict_cell_bf16", "restrict", "restrict_cell_cuda", "bf16_launches"),
    ("tail_down_bf16", "tail", "tail_down_cuda", "bf16_launches"),
    ("tail_up_bf16", "tail", "tail_up_cuda", "bf16_launches"),
    ("fv4_stencil_periodic_bf16", "stencils", "fv4_stencil_cuda",
     "periodic_bf16_launches"),
    ("r1_stencil_bf16", "stencils_r1", "r1_stencil_cuda", "bf16_launches"),
    ("r1_stencil_periodic_bf16", "stencils_r1", "r1_stencil_cuda",
     "periodic_bf16_launches"),
    ("r1_stream_bf16", "stencils_r1", "r1_stream_cuda", "bf16_launches"),
    ("r1_stream_periodic_bf16", "stencils_r1", "r1_stream_cuda", "periodic_bf16_launches"),
    ("r1_gsrb2_bf16", "stencils_r1", "r1_gsrb2_cuda", "bf16_launches"),
    ("fv4_slab_bf16", "stencils", "fv4_slab_cuda", "bf16_launches"),
    ("fv4_overlap_interior_bf16", "stencils", "fv4_overlap_interior_cuda", "bf16_launches"),
    ("fv4_overlap_edge_bf16", "stencils", "fv4_overlap_edge_cuda", "bf16_launches"),
    ("r1_slab_bf16", "stencils_r1", "r1_slab_cuda", "bf16_launches"),
    ("r1_gsrb2_slab_bf16", "stencils_r1", "r1_gsrb2_slab_cuda", "bf16_launches"),
    ("fv4_slab_kslab_bf16", "stencils", "fv4_slab_cuda", "kslab_bf16_launches"),
    ("fv4_overlap_interior_kslab_bf16", "stencils", "fv4_overlap_interior_cuda",
     "kslab_bf16_launches"),
    ("fv4_overlap_edge_kslab_bf16", "stencils", "fv4_overlap_edge_cuda",
     "kslab_bf16_launches"),
    ("r1_slab_kslab_bf16", "stencils_r1", "r1_slab_cuda", "kslab_bf16_launches"),
    ("r1_gsrb2_slab_kslab_bf16", "stencils_r1", "r1_gsrb2_slab_cuda", "kslab_bf16_launches"),
    ("fv4_small", "stencils", "fv4_small", "launches"),
)
# (name, module, plain version) of every plain version's call count
PLAINS = (
    ("fv4_stencil_plain", "stencils", "fv4_stencil_plain"),
    ("fv4_subtile_plain", "stencils", "fv4_subtile_plain"),
    ("fv4_gsrb2_plain", "stencils", "fv4_gsrb2_plain"),
    ("fv4_slab_plain", "stencils", "fv4_slab_plain"),
    ("fv4_overlap_interior_plain", "stencils", "fv4_overlap_interior_plain"),
    ("fv4_overlap_edge_plain", "stencils", "fv4_overlap_edge_plain"),
    ("tail_down_plain", "tail", "tail_down_plain"),
    ("tail_up_plain", "tail", "tail_up_plain"),
    ("tail_v_plain", "tail", "tail_v_plain"),
    ("restrict_cell_plain", "restrict", "restrict_cell_plain"),
    ("r1_stencil_plain", "stencils_r1", "r1_stencil_plain"),
    ("r1_gsrb2_plain", "stencils_r1", "r1_gsrb2_plain"),
    ("r1_slab_plain", "stencils_r1", "r1_slab_plain"),
    ("r1_gsrb2_slab_plain", "stencils_r1", "r1_gsrb2_slab_plain"),
)


def _fn(module: str, name: str):
    import importlib

    return getattr(importlib.import_module(f"hpgmg_tpu_torch.kernels.{module}"), name)


def reset():
    """Set every launch and call count to 0."""
    for _, mod, fn, attr in KERNELS:
        setattr(_fn(mod, fn), attr, 0)
    for _, mod, fn in PLAINS:
        _fn(mod, fn).calls = 0


def read() -> Tuple[Dict[str, int], Dict[str, int]]:
    """({kernel: launches}, {plain version: calls})."""
    return ({name: getattr(_fn(mod, fn), attr) for name, mod, fn, attr in KERNELS},
            {name: _fn(mod, fn).calls for name, mod, fn in PLAINS})
