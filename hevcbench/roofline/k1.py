"""K1, ssd_grid_plane (csrc/ssd_grid_plane.cu): the exact SSD of every CTU
against each of the (2R + 1)^2 displacements, the windows read from the
reference plane cut to R samples of padding.  Each SSD term counts as the
correlation's multiply-add."""

KERNEL = "ssd_grid_plane_kernel"
COUNTER = ("hevcasm_tpu_torch.kernels.search", "ssd_grid_plane")


def cost(g: dict) -> tuple[float, float]:
    r, b = g["search_range"], g["ctu"]
    n = (g["coded_height"] // b) * (g["width"] // b)
    num = 2 * r + 1
    plane = (g["coded_height"] + 2 * r) * (g["width"] + 2 * r)
    return 2.0 * n * num * num * b * b, float(n * b * b + plane + n * num * num * 4)
