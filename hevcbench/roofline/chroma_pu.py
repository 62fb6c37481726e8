"""chroma_pu_fused (csrc/chroma_fused.cu chroma_pu_kernel), the RD P frame's
chroma at an MV a 4x4 tile: both source and both reference chroma planes
read, both reconstructions written, and the MV field (the 8x8 luma tiles'
MVs, two int32 each) and the two counts; bound by those bytes.  Its products
(the 4-tap passes, 11 multiply-adds a predicted sample, and the 4x4
residual's four passes of 4) fall far below them.

A program without the kernel has no counter: ``LAUNCHES`` then reads 0, and
the trace holds no record of it."""

import importlib

KERNEL = "chroma_pu_kernel"
COUNTER = ("hevcbench.roofline.chroma_pu", "LAUNCHES")
TILE = 8                          # the luma side of the tiles an MV drives


class _Launches:
    @property
    def launches(self) -> int:
        mod = importlib.import_module("hevcasm_tpu_torch.kernels.chroma_fused")
        return getattr(getattr(mod, "chroma_pu_fused", None), "launches", 0)


LAUNCHES = _Launches()


def cost(g: dict) -> tuple[float, float]:
    b = g["ctu"]
    n = (g["coded_height"] // b) * (g["width"] // b)
    plane = (g["coded_height"] // 2) * (g["width"] // 2)
    samples = 2 * plane
    ops = 2 * samples * 11 + 2 * samples * 4 * 4
    return float(ops), float(6 * plane + n * (b // TILE) ** 2 * 2 * 4 + 2 * 4)
