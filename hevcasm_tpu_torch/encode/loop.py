"""The inter-frame inner loop, the counterpart of
``hevcasm_tpu.encode.loop``:

  full-search ME -> quarter-pel refine -> predict -> residual -> 8x8 DCT
  -> quantize -> dequantize -> IDCT + add -> recon

``encode_inter_frame`` is the entry point.  With
``inter_impl="fused_dma"`` a CUDA frame runs on two hand-written kernels:
K1 (kernels.search.ssd_grid_plane) scores the integer search and K2
(kernels.inter_fused.inter_ctu_fused_dma) refines and codes each CTU.  A
CPU frame runs the plain PyTorch version of every step, and so does a CUDA
frame when ``tiers=Tier.REF``.  Every path gives the same integers.

Quantizer parameters follow the HM convention for 8-bit video:
  forward:  scale = QUANT_SCALES[qp%6],  shift = 21 + qp//6 - log2(TU),
            offset such that the added rounding = (85 or 171) << (shift - 9)
  inverse:  scale = DEQUANT_SCALES[qp%6] << (qp//6), shift = log2(TU) - 1

Configuration values whose code is not ported yet raise
NotImplementedError naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import registry
from ..config import Tier
from ..kernels import inter_fused, search  # noqa: F401 (registers K1, K2)
from ..utils.psnr import psnr
from ..utils.tensor import as_tensor
from . import ctu as ctu_mod
from . import motion

__all__ = ["EncodeConfig", "QUANT_SCALES", "DEQUANT_SCALES", "PU_LAYOUT_NAMES",
           "config_from_fields", "encode_inter_frame"]

QUANT_SCALES = (26214, 23302, 20560, 18396, 16384, 14564)
DEQUANT_SCALES = (40, 45, 51, 57, 64, 72)

#: Names of the PU layouts the RDO partition search knows (the keys of
#: hevcasm_tpu.encode.partition.PU_LAYOUTS).
PU_LAYOUT_NAMES = ("2Nx2N", "2NxN", "Nx2N", "NxN", "quarter", "eighth")


@dataclasses.dataclass(frozen=True)
class EncodeConfig:
    """Every field, default and guard of ``hevcasm_tpu``'s EncodeConfig.

    The implementation fields name interchangeable ways to compute the
    same integers: me_metric / me_strategy (integer search), search_impl
    ("auto" runs kernel K1 for a CUDA frame with the SSD metric, full
    search, 64x64 CTUs and R <= 32, else the plain grid search),
    fused_refine / refine_impl / residual_impl (the staged path), and
    inter_impl ("stages" or "fused_dma", the K2 path).
    """

    ctu: int = 64
    tu: int = 8
    intra_block: int = 32
    search_range: int = 32
    qp: int = 32
    me_metric: str = "ssd"
    me_strategy: str = "full"
    search_impl: str = "auto"
    fused_refine: bool = False
    refine_impl: str = "mxu"
    residual_impl: str = "mxu"
    intra_mode: str = "open_loop"
    strong_intra_smoothing: bool = True
    inter_impl: str = "stages"
    fused_group: int = 6
    pu_decision: bool = False
    pu_layouts: tuple = ("2Nx2N", "2NxN", "Nx2N", "NxN", "quarter")
    tu_sizes: tuple = ()

    def __post_init__(self):
        _check = {
            "me_metric": ("sad", "ssd"),
            "me_strategy": ("full", "pyramid"),
            "search_impl": ("auto", "grid", "slab", "mv", "dma"),
            "refine_impl": ("mxu", "ref"),
            "residual_impl": ("mxu", "pallas", "ref"),
            "intra_mode": ("open_loop", "wavefront"),
            "inter_impl": ("stages", "fused", "fused_batched", "fused_dma",
                           "mega"),
        }
        for field, valid in _check.items():
            v = getattr(self, field)
            if v not in valid:
                raise ValueError(f"{field}={v!r} (valid: {', '.join(valid)})")
        if self.search_impl in ("mv", "dma", "slab") and not (
            self.me_metric == "ssd" and self.me_strategy == "full"
            and self.ctu == 64 and self.ctu + 2 * self.search_range == 128
        ):
            raise ValueError(
                f"search_impl={self.search_impl!r} covers me_metric='ssd', "
                "me_strategy='full', ctu=64, search_range=32 "
                "(use 'auto' or 'grid')"
            )
        if self.inter_impl == "mega" and (
            self.me_metric != "ssd" or self.me_strategy != "full"
        ):
            raise ValueError(
                "inter_impl='mega' always searches exhaustive SSD; it cannot "
                "honor me_metric='sad' or me_strategy='pyramid'"
            )
        if self.inter_impl == "mega" and (self.tu_sizes or self.pu_decision):
            raise ValueError(
                "inter_impl='mega' does not compose with tu_sizes/"
                "pu_decision (use 'stages' or a fused_* mode)"
            )
        if self.inter_impl in ("fused", "fused_batched", "fused_dma",
                               "mega") and self.tu != 8:
            raise ValueError(
                f"inter_impl={self.inter_impl!r} hardwires 8x8 TUs; "
                f"tu={self.tu} requires inter_impl='stages'"
            )
        for name in self.pu_layouts:
            if name not in PU_LAYOUT_NAMES:
                raise ValueError(
                    f"pu_layouts entry {name!r} (valid: {', '.join(PU_LAYOUT_NAMES)})"
                )

    @property
    def tu_log2(self) -> int:
        return self.tu.bit_length() - 1

    def quant_params(self, intra: bool = False):
        qp = self.qp
        shift = 21 + qp // 6 - self.tu_log2
        offset = (171 if intra else 85) << 7  # == x << (shift-9-(shift-16))
        scale = QUANT_SCALES[qp % 6]
        return scale, shift, offset

    def dequant_params(self):
        qp = self.qp
        scale = DEQUANT_SCALES[qp % 6] << (qp // 6)
        shift = self.tu_log2 - 1
        return scale, shift


def config_from_fields(d: dict) -> EncodeConfig:
    """The port's EncodeConfig from ``dataclasses.asdict`` of a
    ``hevcasm_tpu`` EncodeConfig (or any dict of its fields), running the
    same guards.  Lists (as from JSON) become tuples."""
    names = {f.name for f in dataclasses.fields(EncodeConfig)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"unknown EncodeConfig fields: {', '.join(unknown)}")
    return EncodeConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in d.items()})


# residual_impl values whose code is still to be ported.
_RESIDUAL_NOT_PORTED = {
    "mxu": "residual_impl='mxu' is not ported yet: "
           "ROADMAP A.5 (xla_opt.residual_pipeline_frame)",
    "pallas": "residual_impl='pallas' is not ported yet: "
              "ROADMAP B4 (residual_pipeline_ctu)",
}

# Configuration values whose code is still to be ported, with the ROADMAP
# item that ports it.
_NOT_PORTED = (
    (lambda c: c.me_metric == "sad", "me_metric='sad'",
     "ROADMAP A.2 (ops/sad.py) and B9 (sad_grid kernel)"),
    (lambda c: c.me_strategy == "pyramid", "me_strategy='pyramid'",
     "ROADMAP A.3 (motion.pyramid_search)"),
    (lambda c: c.search_impl in ("mv", "dma"), "search_impl='mv'/'dma'",
     "ROADMAP B17 (search_mv / search_mv_dma)"),
    (lambda c: c.inter_impl == "mega", "inter_impl='mega'",
     "ROADMAP B19 (encode_ctu_mega)"),
    (lambda c: c.inter_impl in ("fused", "fused_batched"),
     "inter_impl='fused'/'fused_batched'",
     "ROADMAP B16 (inter_ctu_fused / inter_ctu_fused_batched)"),
    (lambda c: c.pu_decision, "pu_decision=True",
     "ROADMAP A.10 (encode/partition.py)"),
    (lambda c: bool(c.tu_sizes), "tu_sizes",
     "ROADMAP A.10 (partition.select_tu_recon)"),
    (lambda c: c.inter_impl == "stages" and c.fused_refine, "fused_refine=True",
     "ROADMAP B11 (refine_quarter_pel_fused)"),
    (lambda c: c.inter_impl == "stages" and not c.fused_refine
     and c.refine_impl == "mxu", "refine_impl='mxu'",
     "ROADMAP A.2 (interp_xla.refine_quarter_pel_mxu as a torch op)"),
)


def _check_ported(cfg: EncodeConfig) -> None:
    for applies, what, item in _NOT_PORTED:
        if applies(cfg):
            raise NotImplementedError(f"{what} is not ported yet: {item}")
    if cfg.inter_impl == "stages" and cfg.residual_impl != "ref":
        raise NotImplementedError(_RESIDUAL_NOT_PORTED[cfg.residual_impl])


def _op(name: str, tiers: Tier):
    fn = registry.get(name, tiers)
    if fn is None:
        raise RuntimeError(f"no implementation of {name!r} in tiers {tiers!r}")
    return fn


def _search_impl_resolved(cfg: EncodeConfig, device: torch.device) -> str:
    """Resolve search_impl='auto': 'slab' (kernel K1) for a CUDA frame with
    the SSD metric, full search, 64x64 CTUs and R <= 32, at any grid
    width; else 'grid' (the plain full_search).  Both give the same MVs."""
    if cfg.search_impl != "auto":
        return cfg.search_impl
    if (
        device.type == "cuda"
        and cfg.me_metric == "ssd" and cfg.me_strategy == "full"
        and cfg.ctu == 64 and 1 <= cfg.search_range <= search.MAX_RADIUS
    ):
        return "slab"
    return "grid"


def _integer_search(src_ctus, ref_padded, pos, cfg: EncodeConfig, grid,
                    tiers: Tier = Tier.ALL):
    """Integer-pel ME (me_strategy='full'): returns (mv_int (n, 2) int32,
    best (n,) int32), the same for every search_impl."""
    r = cfg.search_range
    impl = _search_impl_resolved(cfg, src_ctus.device)
    if impl == "slab":
        return motion.full_search_slab(src_ctus, ref_padded, r, grid,
                                       grid_plane_fn=_op("ssd_grid_plane", tiers))
    return motion.full_search(src_ctus, ref_padded, pos, r,
                              grid_fn=_op("ssd_grid", tiers), grid=grid)


def _residual_pipeline(src_blocks, pred_blocks, cfg: EncodeConfig, intra: bool,
                       luma: bool = True, tiers: Tier = Tier.ALL):
    """residual -> TU transform -> quant -> dequant -> inverse + add.
    Returns (recon_blocks (n, B, B) uint8, nnz () int32, cbf (n*(B/tu)^2,)
    bool)."""
    if cfg.residual_impl != "ref":
        raise NotImplementedError(_RESIDUAL_NOT_PORTED[cfg.residual_impl])
    # HEVC uses the DST-VII for 4x4 intra luma TUs; chroma uses the DCT.
    tr_type = 1 if (intra and luma and cfg.tu == 4) else 0
    scale, shift, offset = cfg.quant_params(intra)
    dscale, dshift = cfg.dequant_params()
    return _op("residual_pipeline", tiers)(
        src_blocks, pred_blocks, scale, shift, offset, dscale, dshift,
        tu=cfg.tu, tr_type=tr_type,
    )


def _inter_core(src_ctus, ref_padded, pos, cfg: EncodeConfig, grid,
                tiers: Tier = Tier.ALL):
    """Integer search + quarter-pel refine + residual at the configured
    composition, for a configuration _check_ported accepts.  src_ctus
    (n, B, B); ref_padded padded by (R + PAD_L/PAD_R); pos (n, 2); grid
    (rows, cols).  Returns (rec_ctus (n, B, B) uint8, mv_qpel (n, 2) int32,
    best (n,) int32, nnz () int32)."""
    r = cfg.search_range
    mv_int, best = _integer_search(src_ctus, ref_padded, pos, cfg, grid, tiers)
    if cfg.inter_impl == "fused_dma":
        start = (pos + mv_int + r).to(torch.int32).contiguous()
        scale, shift, offset = cfg.quant_params(False)
        dscale, dshift = cfg.dequant_params()
        rec_ctus, frac, _, nnz_tu, _ = _op("inter_ctu_fused_dma", tiers)(
            src_ctus, ref_padded, start, scale, shift, offset, dscale, dshift,
            group=cfg.fused_group,
        )
        mv_qpel = mv_int * 4 + torch.stack([frac // 4, frac % 4], dim=-1)
        return rec_ctus, mv_qpel.to(torch.int32), best, nnz_tu.sum(dtype=torch.int32)
    pred, mv_qpel, _ = motion.refine_quarter_pel(
        src_ctus, ref_padded, pos, mv_int, r, refine_fn=_op("refine_qpel", tiers))
    rec_ctus, nnz, _ = _residual_pipeline(src_ctus, pred, cfg, intra=False,
                                          tiers=tiers)
    return rec_ctus, mv_qpel, best, nnz


def encode_inter_frame(cur, ref, cfg: EncodeConfig = EncodeConfig(),
                       tiers: Tier = Tier.ALL) -> dict:
    """Encode one inter (P) frame against a reference plane.

    cur, ref: (H, W) uint8 tensors (or numpy arrays) on one device, H and W
    multiples of cfg.ctu.  ``tiers`` masks the implementations the
    registry may pick: Tier.ALL runs the kernels on CUDA tensors,
    Tier.REF the plain versions on any device.

    Returns {"recon": (H, W) uint8, "mvs": (n, 2) int32 quarter-pel,
    "sad": (n,) int32 best integer score, "nnz": () int32 coded
    coefficients, "psnr_db": () float32}.
    """
    cur = as_tensor(cur)
    ref = as_tensor(ref, cur.device)
    if cur.dim() != 2 or cur.shape != ref.shape or cur.dtype != torch.uint8 \
            or ref.dtype != torch.uint8:
        raise ValueError("cur and ref must be (H, W) uint8 planes of one shape")
    _check_ported(cfg)
    h, w = cur.shape
    gr, gc = ctu_mod.grid_shape(h, w, cfg.ctu)
    src_ctus = ctu_mod.tile_frame(cur, cfg.ctu).contiguous()
    r = cfg.search_range
    pl, pr = r + motion.PAD_L, r + motion.PAD_R
    ref_padded = ctu_mod.pad_frame(ref, pl, pr, pl, pr)
    pos = motion.ctu_positions(gr, gc, cfg.ctu, cur.device)
    rec_ctus, mv_qpel, best, nnz = _inter_core(
        src_ctus, ref_padded, pos, cfg, (gr, gc), tiers)
    recon = ctu_mod.untile_frame(rec_ctus, h, w)
    return {
        "recon": recon,
        "mvs": mv_qpel,
        "sad": best,
        "nnz": nnz,
        "psnr_db": psnr(cur, recon),
    }
