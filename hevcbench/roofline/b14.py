"""B14, base_grids_ctu (csrc/base_grids.cu) at base 8, as the six PU layouts
down to 8x8 run it: the exact SSD of each of a CTU's 64 sub-blocks of 8x8
against each of the (2R + 1)^2 displacements (a multiply-add a term), the
windows read from the reference plane cut to R samples of padding; out,
every sub-block's int32 grid (552 MB a 1080p frame at R = 32), which bound
it."""

KERNEL = "base_grids_kernel"
COUNTER = ("hevcasm_tpu_torch.kernels.base_grids", "base_grids_ctu")
BASE = 8


def cost(g: dict) -> tuple[float, float]:
    r, b = g["search_range"], g["ctu"]
    n = (g["coded_height"] // b) * (g["width"] // b)
    num = 2 * r + 1
    subs = n * (b // BASE) ** 2
    plane = (g["coded_height"] + 2 * r) * (g["width"] + 2 * r)
    return 2.0 * subs * num * num * BASE * BASE, float(n * b * b + plane + subs * num * num * 4)
