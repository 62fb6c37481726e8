"""B3, bi_ctu_fused_dma (csrc/bi_fused.cu): each CTU's two quarter-pel
refinements, one a reference at its own integer MV (K2's count each: the 4
horizontal 8-tap passes over b + 7 rows, 16 vertical candidates, the winner
once more, and the score's difference and sum a candidate sample), the mean
(p0 + p1 + 64, two additions a sample) and the 8x8 residual (four separable
passes of 8 multiply-adds an output), the windows read from the two padded
reference planes stacked by rows; outputs the recon, both fractions, and
nnz and bits a TU."""

KERNEL = "bi_fused_kernel"
COUNTER = ("hevcasm_tpu_torch.kernels.bi_fused", "bi_ctu_fused_dma")


def cost(g: dict) -> tuple[float, float]:
    r, b, tu = g["search_range"], g["ctu"], 8
    n = (g["coded_height"] // b) * (g["width"] // b)
    macs = 4 * (b + 7) * b * 8 + 16 * b * b * 8 + b * b * 8
    refine = 2 * macs + 2 * 16 * b * b
    mean = 2 * b * b
    residual = 2 * 4 * b * b * tu
    plane = (g["coded_height"] + 2 * r + 7) * (g["width"] + 2 * r + 7)
    out = b * b + 8 + 2 * (b // tu) ** 2 * 4
    return (float(n * (2 * refine + mean + residual)),
            float(n * b * b + 2 * plane + 2 * n * 8 + n * out))
