"""The distributed path (counterpart of hpgmg_tpu/parallel/): levels
decomposed over a 3D grid of ranks (``torch.distributed``, one process
per rank), halo exchanges before every stencil application, and the slab
kernels K8a-K8d on each rank's local block."""
