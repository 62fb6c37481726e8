"""B13, refine_qpel_costmap_dma (csrc/costmap.cu) on 8x8 tiles, as the six PU
layouts down to 8x8 run it: each tile's 16 quarter-pel fractions at its
integer MV (the 4 horizontal 8-tap passes over the tile's 15 rows, the 16
vertical candidates, and the score's difference and sum a candidate
sample), the windows read from the padded reference plane at each tile's
offsets; out, the 16 costs and the 15x15 window of each tile."""

KERNEL = "costmap_plane_kernel"
COUNTER = ("hevcasm_tpu_torch.kernels.costmap", "refine_qpel_costmap_dma")
SIDE = 8


def cost(g: dict) -> tuple[float, float]:
    r, b = g["search_range"], g["ctu"]
    tiles = (g["coded_height"] // b) * (g["width"] // b) * (b // SIDE) ** 2
    win = SIDE + 7
    macs = 4 * win * SIDE * 8 + 16 * SIDE * SIDE * 8
    plane = (g["coded_height"] + 2 * r + 7) * (g["width"] + 2 * r + 7)
    return (float(tiles * (2 * macs + 2 * 16 * SIDE * SIDE)),
            float(tiles * SIDE * SIDE + plane + tiles * 8 + tiles * (16 * 4 + win * win)))
