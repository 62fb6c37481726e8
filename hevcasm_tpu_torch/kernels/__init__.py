"""Hand-written CUDA kernels (tier KERNEL), each beside its plain PyTorch
version (tier REF).

* search       K1 ``ssd_grid_plane``: exact SSD grids of every CTU, windows
               read from the padded reference plane; B7
               ``ssd_grid_plane_multi``: the same against k planes; B8
               ``ssd_grid``: exact SSD grids of square blocks against given
               windows; B17 ``search_mv`` / ``search_mv_dma``: the exhaustive
               SSD search with its first minimum taken in the kernel, on
               gathered windows or read from the plane.
* sad          B9 ``sad_grid``: exact SAD grids of square blocks against
               given windows (packed: four absolute differences an
               instruction); B10 ``sad``
               / ``sad_multiref``: the SAD of blocks against one reference
               or k.
* mc           B5 ``pred_uni[_batched]`` and B6 ``pred_bi[_batched]``: uni-
               and bi-prediction of blocks at given fractions (8-tap luma,
               4-tap chroma).
* mega         B19 ``encode_ctu_mega``: search, first minimum, quarter-pel
               refinement and 8x8 residual of each CTU in one launch.
* inter_fused  K2 ``inter_ctu_fused_dma``: quarter-pel refinement fused with
               the 8x8 residual pipeline, windows read from the plane; B16
               ``inter_ctu_fused`` / ``inter_ctu_fused_batched``: the same on
               gathered windows; B11 ``refine_quarter_pel_fused``: the
               refinement alone, blocks of 8 to 64.
* residual_ctu B4 ``residual_pipeline_ctu``: the TU residual pipeline of
               64x64 CTUs at 4x4 (DCT or DST-VII) to 32x32 TUs.
* bi_fused     B3 ``bi_ctu_fused_dma``: both references' refinements, the
               bi-prediction combine and the 8x8 residual pipeline.
* costmap      B12 ``refine_qpel_costmap`` and B13
               ``refine_qpel_costmap_dma``: the 16 quarter-pel QPEL_SCOREs of
               8- to 64-wide tiles, windows gathered or read from the plane.
* base_grids   B14 ``base_grids_ctu`` and B15 ``base_layout_decide``: the
               sub-block SSD grids of every CTU, and each PU's first minimum
               (the grids on the u8 tensor cores, kept in the block); B18
               ``base_layout_decide_fc``: B15 at base 16, R = 32.
* chroma_fused ``chroma_p_fused``: a 4:2:0 P frame's chroma, both planes in
               one launch (windows from the reference planes, B5's 4-tap
               core, the residual stage's 4x4 TUs); the port's own, no TPU
               kernel.
* intra_wave   ``intra_wave_fused``: one wave of the closed-loop I frame
               (32x32 blocks, 8x8 TUs) in one launch (neighbours from the
               tiled canvas, the 35-mode decision in the Hadamard domain on
               the CUDA cores, the residual stage's 8x8 TUs); the port's
               own, no TPU kernel.
* build        compiles ``csrc/*.cu`` with nvcc on first use and loads it.

Importing a kernel module registers both tiers of its op; nothing is
compiled and no device is touched until a wrapper gets a CUDA tensor.
"""
