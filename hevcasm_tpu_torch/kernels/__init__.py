"""Hand-written CUDA kernels (tier KERNEL), each beside its plain PyTorch
version (tier REF).

* search       K1 ``ssd_grid_plane``: exact SSD grids of every CTU, windows
               read from the padded reference plane.
* inter_fused  K2 ``inter_ctu_fused_dma``: quarter-pel refinement fused with
               the 8x8 residual pipeline.
* build        compiles ``csrc/*.cu`` with nvcc on first use and loads it.

Importing a kernel module registers both tiers of its op; nothing is
compiled and no device is touched until a wrapper gets a CUDA tensor.
"""
