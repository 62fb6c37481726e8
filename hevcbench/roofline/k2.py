"""K2, inter_ctu_fused_dma (csrc/inter_fused.cu): each CTU's quarter-pel
refinement at its integer MV (the 4 horizontal 8-tap passes over b + 7 rows,
16 vertical candidates, the winner once more, and the score's difference
and sum a candidate sample) and its 8x8 residual (four separable passes of
8 multiply-adds an output), the windows read from the padded reference
plane; outputs the recon, fraction and cost, and nnz and bits a TU."""

KERNEL = "inter_fused_kernel"
COUNTER = ("hevcasm_tpu_torch.kernels.inter_fused", "inter_ctu_fused_dma")


def cost(g: dict) -> tuple[float, float]:
    r, b, tu = g["search_range"], g["ctu"], 8
    n = (g["coded_height"] // b) * (g["width"] // b)
    macs = 4 * (b + 7) * b * 8 + 16 * b * b * 8 + b * b * 8
    refine = 2 * macs + 2 * 16 * b * b
    residual = 2 * 4 * b * b * tu
    plane = (g["coded_height"] + 2 * r + 7) * (g["width"] + 2 * r + 7)
    out = b * b + 8 + 2 * (b // tu) ** 2 * 4
    return float(n * (refine + residual)), float(n * b * b + plane + n * 8 + n * out)
