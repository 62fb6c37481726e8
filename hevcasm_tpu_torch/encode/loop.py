"""The inter-frame inner loop, the counterpart of
``hevcasm_tpu.encode.loop``:

  full-search ME -> quarter-pel refine -> predict -> residual -> 8x8 DCT
  -> quantize -> dequantize -> IDCT + add -> recon

``encode_inter_frame`` is the entry point, and
``encode_inter_frame_multiref`` its form with k reference planes.  With
``inter_impl="fused_dma"`` a CUDA frame runs on two hand-written kernels:
K1 (kernels.search.ssd_grid_plane) scores the integer search and K2
(kernels.inter_fused.inter_ctu_fused_dma) refines and codes each CTU;
``"fused"`` / ``"fused_batched"`` run B16 (kernels.inter_fused.
inter_ctu_fused) on gathered windows, ``fused_refine=True`` B11
(refine_quarter_pel_fused) and ``residual_impl="pallas"`` B4
(kernels.residual_ctu.residual_pipeline_ctu).  ``inter_impl="mega"`` runs
the whole inner loop in B19 (kernels.mega.encode_ctu_mega).  The integer
search runs B17 (kernels.search.search_mv / search_mv_dma, the first
minimum in the kernel) under ``search_impl="mv"`` / ``"dma"``, B9
(kernels.sad.sad_grid) under ``me_metric="sad"``, and B8 or B9 at both
levels of ``me_strategy="pyramid"`` (motion.pyramid_search).  The
multi-reference frame scores all k planes in B7
(kernels.search.ssd_grid_plane_multi), or in B9 under the SAD metric.  The
RDO frame (``pu_decision=True``, encode.partition) decides each CTU's PU
layout in B15 (kernels.base_grids.base_layout_decide, or B14 base_grids_ctu
when the "eighth" layout sets base 8; at R != 32, B8 kernels.search.ssd_grid
scores the sub-block grids) and refines its PUs in B13
(kernels.costmap.refine_qpel_costmap_dma); ``tu_sizes`` picks each CTU's TU
size.  Its luma (_rd_core) is shared with the 4:2:0 RD frame of
encode.video.encode_inter_frame_yuv.  A CPU frame runs the plain PyTorch version of every step, and so
does a CUDA frame when ``tiers=Tier.REF``.  Every path gives the same
integers.

``encode_intra_frame`` codes an I frame from open-loop neighbours (the 35
modes decided by SATD; at 32x32 in the Hadamard domain through the
constant matrices of kernels.intra_matrix, float64 products; no registry
kernel), and ``encode_gop`` an open-loop IPPP GOP from its first frame.

Quantizer parameters follow the HM convention for 8-bit video:
  forward:  scale = QUANT_SCALES[qp%6],  shift = 21 + qp//6 - log2(TU),
            offset such that the added rounding = (85 or 171) << (shift - 9)
  inverse:  scale = DEQUANT_SCALES[qp%6] << (qp//6), shift = log2(TU) - 1

Each entry point accepts what hevcasm_tpu's accepts, and a configuration
it rejects raises the same exception type (ValueError where hevcasm_tpu
stops on a bare assert).  Every value of every EncodeConfig field runs.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import registry
from ..config import Tier
# Importing the kernel modules registers K1, K2, B3, B4, B7-B17 and B19.
from ..kernels import (base_grids, bi_fused, costmap, inter_fused, mega,  # noqa: F401
                       residual_ctu, sad, search)
from ..kernels.intra_matrix import intra_mode_decision_t, pred_intra_all_modes_mm
from ..ops.pred_intra import (filter_flag, filter_references, pred_intra,
                              strong_smoothing_condition, substitute_references)
from ..ops.residual import residual_pipeline_frame
from ..ops.satd import satd
from ..utils.psnr import psnr
from ..utils.tensor import as_tensor, entry_device, first_min
from ..utils.trace import span
from . import ctu as ctu_mod
from . import motion
from . import partition

__all__ = ["EncodeConfig", "QUANT_SCALES", "DEQUANT_SCALES", "PU_LAYOUT_NAMES",
           "config_from_fields", "encode_inter_frame", "encode_inter_frame_multiref",
           "encode_intra_frame", "encode_gop"]

QUANT_SCALES = (26214, 23302, 20560, 18396, 16384, 14564)
DEQUANT_SCALES = (40, 45, 51, 57, 64, 72)

#: Names of the PU layouts the RDO partition search knows.
PU_LAYOUT_NAMES = tuple(partition.PU_LAYOUTS)


@dataclasses.dataclass(frozen=True)
class EncodeConfig:
    """Every field, default and guard of ``hevcasm_tpu``'s EncodeConfig.

    The implementation fields name interchangeable ways to compute the
    same integers: search_impl ("auto" runs kernel K1 for a CUDA frame
    with the SSD metric, full search, 64x64 CTUs and R <= 32, else the
    grid search on gathered windows, which runs kernel B8, or B9 for the
    SAD metric, on a CUDA frame; "mv" / "dma" run B17), fused_refine /
    refine_impl / residual_impl (the staged path: B11 for fused_refine, B4
    for residual_impl "pallas" at 64x64 CTUs and 8x8 DCT TUs, the plain
    versions otherwise), and inter_impl ("stages", "fused_dma" for the K2
    path, "fused" / "fused_batched" for B16, "mega" for B19; the B frame
    runs B3 under the three fused values).  me_metric and me_strategy
    choose the search itself ("sad" scores |a - b|; "pyramid" searches a
    4x-decimated level first); they change the MVs.
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


def _check_inter_core(cfg: EncodeConfig) -> None:
    """What _inter_core rejects before any work, as hevcasm_tpu does: it
    serves the fixed CTU/TU geometry only."""
    if cfg.pu_decision or cfg.tu_sizes:
        raise ValueError(
            "this entry point runs the fixed CTU/TU geometry; "
            "pu_decision/tu_sizes compose only with encode_inter_frame"
        )


def _op(name: str, tiers: Tier):
    fn = registry.get(name, tiers)
    if fn is None:
        raise RuntimeError(f"no implementation of {name!r} in tiers {tiers!r}")
    return fn


def _search_impl_resolved(cfg: EncodeConfig, device: torch.device) -> str:
    """Resolve search_impl='auto': 'slab' (kernel K1) for a CUDA frame with
    the SSD metric, full search, 64x64 CTUs and R <= 32, at any grid
    width; else 'grid' (full_search, B8 for a CUDA frame).  Both give the
    same MVs."""
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
    """Integer-pel ME by cfg.me_strategy and cfg.me_metric: the pyramid
    search (both levels in the metric's grid scorer, B8 or B9), or the full
    search by the resolved search_impl: 'slab' (K1), 'dma' (B17 reading the
    windows from ref_padded), 'mv' (B17 on the gathered windows) or 'grid'
    (the metric's grid scorer on the gathered windows).  Returns (mv_int
    (n, 2) int32, best (n,) int32), the same for every search_impl."""
    r = cfg.search_range
    grid_fn = motion.grid_metric_fn(cfg.me_metric, tiers)
    if cfg.me_strategy == "pyramid":
        # The coarse level decimates the unpadded reference.
        pl = r + motion.PAD_L
        ref = ref_padded[pl:pl + grid[0] * cfg.ctu, pl:pl + grid[1] * cfg.ctu]
        return motion.pyramid_search(src_ctus, ref, ref_padded, pos, r, grid_fn=grid_fn,
                                     grid=grid)
    impl = _search_impl_resolved(cfg, src_ctus.device)
    if impl == "slab":
        return motion.full_search_slab(src_ctus, ref_padded, r, grid,
                                       grid_plane_fn=_op("ssd_grid_plane", tiers))
    if impl == "dma":
        return _op("search_mv_dma", tiers)(src_ctus, ref_padded, pos, r)
    if impl == "mv":
        b = src_ctus.shape[-1]
        win = motion.extract_aligned_windows(ref_padded, (motion.PAD_L, motion.PAD_L), grid,
                                             b, b + 2 * r)
        return _op("search_mv", tiers)(src_ctus, win, 2 * r + 1)
    return motion.full_search(src_ctus, ref_padded, pos, r, grid_fn=grid_fn, grid=grid)


def _residual_pipeline(src_blocks, pred_blocks, cfg: EncodeConfig, intra: bool,
                       luma: bool = True, tiers: Tier = Tier.ALL):
    """residual -> TU transform -> quant -> dequant -> inverse + add.
    residual_impl 'mxu' runs ops.residual.residual_pipeline_frame, 'pallas'
    kernel B4 (the tiers' residual_pipeline_ctu) on 64x64 blocks with 8x8
    DCT TUs, and 'ref' (and 'pallas' outside that geometry, as in
    hevcasm_tpu) the plain residual_pipeline.  Returns (recon_blocks (n, B,
    B) uint8, nnz () int32, cbf (n*(B/tu)^2,) bool)."""
    # HEVC uses the DST-VII for 4x4 intra luma TUs; chroma uses the DCT.
    tr_type = 1 if (intra and luma and cfg.tu == 4) else 0
    scale, shift, offset = cfg.quant_params(intra)
    dscale, dshift = cfg.dequant_params()
    if cfg.residual_impl == "mxu":
        rec, nnz, cbf, _ = residual_pipeline_frame(
            src_blocks, pred_blocks, scale, shift, offset, dscale, dshift,
            tu=cfg.tu, tr_type=tr_type)
        return rec, nnz, cbf.reshape(-1)
    if (cfg.residual_impl == "pallas" and cfg.tu == 8 and src_blocks.shape[-1] == 64
            and tr_type == 0):
        rec, nnz_tu = _op("residual_pipeline_ctu", tiers)(
            src_blocks, pred_blocks, scale, shift, offset, dscale, dshift)
        return rec, nnz_tu.sum(dtype=torch.int32), (nnz_tu > 0).reshape(-1)
    # hevcasm_tpu runs its plain composition here on every device.
    return _op("residual_pipeline", Tier.REF)(
        src_blocks, pred_blocks, scale, shift, offset, dscale, dshift,
        tu=cfg.tu, tr_type=tr_type,
    )


def _inter_core(src_ctus, ref_padded, pos, cfg: EncodeConfig, grid,
                tiers: Tier = Tier.ALL):
    """Integer search + quarter-pel refine + residual at the configured
    composition: K2 for inter_impl='fused_dma', B16 for 'fused' and
    'fused_batched', else the staged path (which also serves 'mega' when
    the yuv frame calls, as in hevcasm_tpu).  src_ctus (n, B, B); ref_padded
    padded by (R + PAD_L/PAD_R); pos (n, 2); grid (rows, cols).  Returns
    (rec_ctus (n, B, B) uint8, mv_qpel (n, 2) int32, best (n,) int32, nnz ()
    int32)."""
    _check_inter_core(cfg)
    with span("hevcasm.search"):
        mv_int, best = _integer_search(src_ctus, ref_padded, pos, cfg, grid, tiers)
    start = (pos + mv_int + cfg.search_range).to(torch.int32).contiguous()
    with span("hevcasm.refine_code"):
        rec_ctus, mv_qpel, nnz = _refine_and_code(src_ctus, ref_padded, start, mv_int, cfg,
                                                  tiers)
    return rec_ctus, mv_qpel, best, nnz


def _refine_and_code(src_ctus, plane, start, mv_int, cfg: EncodeConfig, tiers: Tier):
    """Quarter-pel refinement and residual of every CTU at its refine-window
    start (n, 2) int32 in ``plane``: K2 reading the windows from the plane
    for inter_impl 'fused_dma', B16 on the gathered (n, B+7, B+7) windows
    for 'fused' and 'fused_batched' (which differ only by the TPU kernel's
    CTU groups), else the staged refine (B11 under fused_refine) + residual.
    refine_impl 'mxu' and 'ref' give the same (pred, frac, cost): the
    banded-matmul form of 'mxu' is a TPU layout device, and hevcasm_tpu runs
    no kernel for either.  Returns (rec_ctus (n, B, B) uint8, mv_qpel (n, 2)
    int32, nnz () int32)."""
    impl = cfg.inter_impl
    if impl in ("fused", "fused_batched", "fused_dma"):
        qargs = (*cfg.quant_params(False), *cfg.dequant_params())
        if impl == "fused_dma":
            rec_ctus, frac, _, nnz_tu, _ = _op("inter_ctu_fused_dma", tiers)(
                src_ctus, plane, start, *qargs, group=cfg.fused_group)
        else:
            win = motion.extract_windows(plane, start, cfg.ctu + motion.TAPS - 1)
            rec_ctus, frac, _, nnz_tu, _ = _op("inter_ctu_fused", tiers)(src_ctus, win, *qargs)
        return rec_ctus, motion.qpel_mvs(mv_int, frac), nnz_tu.sum(dtype=torch.int32)
    win = motion.extract_windows(plane, start, cfg.ctu + motion.TAPS - 1)
    refine = (_op("refine_quarter_pel_fused", tiers) if cfg.fused_refine
              else _op("refine_qpel", Tier.REF))
    pred, frac, _ = refine(src_ctus, win)
    rec_ctus, nnz, _ = _residual_pipeline(src_ctus, pred, cfg, intra=False, tiers=tiers)
    return rec_ctus, motion.qpel_mvs(mv_int, frac), nnz


def _prepare_frame(cfg: EncodeConfig, cur, *refs, device=None):
    """Check that cur and the reference planes are (H, W) uint8 planes of
    one shape, put cur on its device (utils.tensor.entry_device) and the
    references beside it, and tile cur into CTUs.  Returns (cur, refs,
    src_ctus, pos, grid)."""
    cur = as_tensor(cur, entry_device(cur, device))
    refs = tuple(as_tensor(ref, cur.device) for ref in refs)
    if cur.dim() != 2 or cur.dtype != torch.uint8 or any(
            ref.shape != cur.shape or ref.dtype != torch.uint8 for ref in refs):
        raise ValueError("cur and ref must be (H, W) uint8 planes of one shape")
    grid = ctu_mod.grid_shape(*cur.shape, cfg.ctu)
    src_ctus = ctu_mod.tile_frame(cur, cfg.ctu).contiguous()
    pos = motion.ctu_positions(*grid, cfg.ctu, cur.device)
    return cur, refs, src_ctus, pos, grid


def _pad_reference(ref: torch.Tensor, search_range: int) -> torch.Tensor:
    """The reference plane edge-padded by (R + PAD_L) top/left and
    (R + PAD_R) bottom/right, as the search and the refinement read it."""
    pl, pr = search_range + motion.PAD_L, search_range + motion.PAD_R
    return ctu_mod.pad_frame(ref, pl, pr, pl, pr)


def _decide_pu(src_ctus, ref_padded, pos, cfg: EncodeConfig, grid, tiers: Tier):
    """The PU decision (partition.select_pu_layout_pruned) with the search
    windows and kernels the configuration and tiers select.  Returns (pred
    (n, 64, 64) uint8, choice (n,) int32, mv_tiles (n, k, k, 2) int32,
    best64 (n,) int32)."""
    with span("hevcasm.pu_decision"):
        r = cfg.search_range
        size = cfg.ctu + 2 * r
        if size % cfg.ctu == 0:
            win = motion.extract_aligned_windows(
                ref_padded, (motion.PAD_L, motion.PAD_L), grid, cfg.ctu, size)
        else:
            win = motion.extract_windows(ref_padded, pos + motion.PAD_L, size)
        return partition.select_pu_layout_pruned(
            src_ctus, ref_padded, pos, win, r, partition.mv_lambda(cfg.qp), cfg.pu_layouts,
            motion.grid_metric_fn(cfg.me_metric, tiers), grid=grid, metric=cfg.me_metric,
            decide_fn=_op("base_layout_decide", tiers), grids_fn=_op("base_grids_ctu", tiers),
            costmap_dma_fn=_op("refine_qpel_costmap_dma", tiers))


def _rd_core(src_ctus, ref_padded, pos, cfg: EncodeConfig, grid, tiers: Tier):
    """The RD P frame's luma, which encode_inter_frame and
    video.encode_inter_frame_yuv share: with pu_decision the PU decision
    (_decide_pu: B15 or B14, the layout decision, B13), else the integer
    search and hevcasm_tpu's (XLA) sweep, whatever refine_impl and
    fused_refine say; then with tu_sizes the TU decision
    (partition.select_tu_recon), else the residual at cfg.tu.  Returns
    (rec_ctus (n, B, B) uint8, mv_field (n, k, k, 2) int32 quarter-pel, the
    MV of each base tile of the PU decision (k = 1 without it), best (n,)
    int32, nnz () int32, and {"pu_layout", "tu_choice"} where decided)."""
    out = {}
    if cfg.pu_decision:
        pred, out["pu_layout"], mv_field, best = _decide_pu(src_ctus, ref_padded, pos, cfg,
                                                            grid, tiers)
    else:
        mv_int, best = _integer_search(src_ctus, ref_padded, pos, cfg, grid, tiers)
        pred, mv_qpel, _ = motion.refine_quarter_pel(
            src_ctus, ref_padded, pos, mv_int, cfg.search_range,
            refine_fn=_op("refine_qpel", Tier.REF))
        mv_field = mv_qpel[:, None, None]
    if cfg.tu_sizes:
        rec_ctus, out["tu_choice"], nnz = partition.select_tu_recon(src_ctus, pred, cfg,
                                                                    cfg.tu_sizes)
    else:
        rec_ctus, nnz, _ = _residual_pipeline(src_ctus, pred, cfg, intra=False, tiers=tiers)
    return rec_ctus, mv_field, best, nnz, out


def encode_inter_frame(cur, ref, cfg: EncodeConfig = EncodeConfig(),
                       tiers: Tier = Tier.ALL, device=None) -> dict:
    """Encode one inter (P) frame against a reference plane.

    cur, ref: (H, W) uint8 tensors or numpy arrays, H and W multiples of
    cfg.ctu.  A tensor cur runs on its own device; a numpy cur on
    ``device``, by default the CUDA card (with none, pass device="cpu").
    ``tiers`` masks the implementations the registry may pick: Tier.ALL
    runs the kernels on CUDA tensors, Tier.REF the plain versions on any
    device.

    Every configuration runs: me_metric "ssd" or "sad", me_strategy "full"
    or "pyramid", every search_impl and inter_impl ("mega": kernel B19, the
    search, refinement and residual of each CTU in one launch, at
    search_range 8, 16, 24 or 32), the PU decision and the TU-size
    selection.

    Returns {"recon": (H, W) uint8, "mvs": (n, 2) int32 quarter-pel,
    "sad": (n,) int32 best integer score (SSD or SAD by cfg.me_metric),
    "nnz": () int32 coded coefficients, "psnr_db": () float32}.  With
    pu_decision=True, "mvs" is each CTU's top-left PU MV, "sad" the
    whole-CTU best integer score and "pu_layout" (n,) int32 the chosen
    index into cfg.pu_layouts; with tu_sizes, "tu_choice" (n,) int32
    indexes cfg.tu_sizes and "nnz" counts coded TUs.
    """
    if cfg.pu_decision:
        partition.base_for(cfg.pu_layouts)
    cur, (ref,), src_ctus, pos, grid = _prepare_frame(cfg, cur, ref, device=device)
    ref_padded = _pad_reference(ref, cfg.search_range)
    out = {}
    if cfg.inter_impl == "mega":      # EncodeConfig rejects it with pu_decision/tu_sizes
        rec_ctus, mv_int, frac, best, nnz_tu = _op("encode_ctu_mega", tiers)(
            src_ctus, ref_padded, pos, cfg.search_range, *cfg.quant_params(False),
            *cfg.dequant_params())
        mv_qpel, nnz = motion.qpel_mvs(mv_int, frac), nnz_tu.sum(dtype=torch.int32)
    elif cfg.pu_decision or cfg.tu_sizes:
        rec_ctus, mv_field, best, nnz, out = _rd_core(src_ctus, ref_padded, pos, cfg, grid,
                                                      tiers)
        mv_qpel = mv_field[:, 0, 0]
    else:
        rec_ctus, mv_qpel, best, nnz = _inter_core(src_ctus, ref_padded, pos, cfg, grid, tiers)
    recon = ctu_mod.untile_frame(rec_ctus, *cur.shape)
    return {"recon": recon, "mvs": mv_qpel, **out, "sad": best, "nnz": nnz,
            "psnr_db": psnr(cur, recon)}


def encode_inter_frame_multiref(cur, refs, cfg: EncodeConfig = EncodeConfig(),
                                tiers: Tier = Tier.ALL, device=None) -> dict:
    """Encode one P frame against k reference planes, choosing each CTU's
    reference (the counterpart of hevcasm_tpu's encode_inter_frame_multiref).

    cur (H, W) uint8 and refs (k, H, W) uint8 (e.g. the last k
    reconstructions), tensors or numpy arrays; devices as for
    encode_inter_frame.  All k references are searched in one call
    (motion.full_search_multi: kernel B7 on a CUDA frame with the SSD
    metric, 64x64 CTUs and R <= 32, else one grid call), and the (ref, mv)
    pair with the smallest integer score wins, the lower reference index on
    a tie.  k == 1 gives encode_inter_frame's recon, mvs and nnz.  Under
    me_metric="sad" the one grid call runs B9 on a CUDA frame.
    search_impl is ignored, as in hevcasm_tpu.  The refinement and residual
    read the k padded planes stacked by rows, reference i's rows starting
    at i * Hp: K2 from that plane under inter_impl 'fused_dma', B16 on the
    (n, B+7, B+7) windows gathered from it under 'fused' / 'fused_batched',
    else the staged refine + residual (which also serves 'mega').

    Returns {"recon": (H, W) uint8, "mvs": (n, 2) int32 quarter-pel,
    "ref_idx": (n,) int32, "nnz": () int32, "psnr_db": () float32}.
    """
    if cfg.me_strategy == "pyramid":
        raise ValueError(
            "encode_inter_frame_multiref searches exhaustively; "
            "me_strategy='pyramid' is not honored here (use 'full')"
        )
    if cfg.pu_decision or cfg.tu_sizes:
        raise ValueError(
            "encode_inter_frame_multiref runs the fixed CTU/TU geometry; "
            "pu_decision/tu_sizes compose only with encode_inter_frame"
        )
    cur = as_tensor(cur, entry_device(cur, device))
    refs = as_tensor(refs, cur.device)
    if refs.dim() != 3 or refs.shape[0] < 1:
        raise ValueError(f"refs must be (k, H, W) with k >= 1, got {tuple(refs.shape)}")
    cur, ref_planes, src_ctus, pos, grid = _prepare_frame(cfg, cur, *refs)
    r = cfg.search_range
    planes = torch.stack([_pad_reference(p, r) for p in ref_planes])    # (k, Hp, Wp)
    mv_int, ref_idx, _ = motion.full_search_multi(
        src_ctus, planes, pos, r, grid_fn=motion.grid_metric_fn(cfg.me_metric, tiers),
        grid=grid, metric=cfg.me_metric,
        grid_plane_multi_fn=_op("ssd_grid_plane_multi", tiers))
    k, hp, wp = planes.shape
    start = pos + mv_int + r
    offsets = torch.stack([ref_idx * hp + start[:, 0], start[:, 1]], dim=-1)
    rec_ctus, mv_qpel, nnz = _refine_and_code(
        src_ctus, planes.reshape(k * hp, wp), offsets.to(torch.int32).contiguous(), mv_int,
        cfg, tiers)
    recon = ctu_mod.untile_frame(rec_ctus, *cur.shape)
    return {"recon": recon, "mvs": mv_qpel, "ref_idx": ref_idx, "nnz": nnz,
            "psnr_db": psnr(cur, recon)}


def _intra_neighbours(frame: torch.Tensor, n: int):
    """Open-loop intra neighbours and their availability for every n x n
    block of an (H, W) plane, blocks in row-major order.

    Returns (left, above (num, 2n) uint8, corner (num,) uint8, left_avail,
    above_avail (num, 2n) bool, corner_avail (num,) bool).  The samples are
    the source's, read with edge clamping; a sample is available when it
    lies in the frame (open loop has no coding-order constraint).
    Substitution (8.4.4.2.2) is the caller's next step."""
    h, w = frame.shape
    gr, gc = ctu_mod.grid_shape(h, w, n)
    dev = frame.device
    ys = torch.arange(gr, device=dev) * n
    xs = torch.arange(gc, device=dev) * n
    i = torch.arange(2 * n, device=dev)
    row_above = (ys - 1).clamp(min=0)
    col_left = (xs - 1).clamp(min=0)
    above = frame[row_above[:, None, None], (xs[:, None] + i).clamp(max=w - 1)[None]]
    left = frame[(ys[:, None] + i).clamp(max=h - 1)[:, None, :], col_left[None, :, None]]
    corner = frame[row_above[:, None], col_left[None, :]]
    yy = ys[:, None].expand(gr, gc).reshape(-1)
    xx = xs[None, :].expand(gr, gc).reshape(-1)
    lav = (xx[:, None] > 0) & (yy[:, None] + i < h)
    aav = (yy[:, None] > 0) & (xx[:, None] + i < w)
    cav = (xx > 0) & (yy > 0)
    return (left.reshape(-1, 2 * n), above.reshape(-1, 2 * n), corner.reshape(-1),
            lav, aav, cav)


def _prepare_intra_refs(left, above, corner, lav, aav, cav, n: int, cfg: EncodeConfig):
    """Substitution and smoothing (8.4.4.2.2-3): returns the plain and the
    filtered reference sets; mode m predicts from the filtered set iff
    filter_flag(m, n).  Strong smoothing applies at n = 32 only, under
    cfg.strong_intra_smoothing."""
    left, above, corner = substitute_references(left, above, corner, lav, aav, cav)
    strong = None
    if n == 32 and cfg.strong_intra_smoothing:
        strong = strong_smoothing_condition(left, above, corner)
    return (left, above, corner), filter_references(left, above, corner, n, strong=strong)


def _satd_cost(a, b):
    """SATD summed over the 8x8 sub-blocks of (m, n, n) blocks: (m,) int32,
    the standard mode-decision cost."""
    per = satd(ctu_mod.split_blocks(a, 8), ctu_mod.split_blocks(b, 8))
    k = (a.shape[-1] // 8) ** 2
    return per.reshape(a.shape[0], k).sum(-1, dtype=torch.int32) if a.dim() == 3 else per


def _intra_mode_sweep(blocks, refs_plain, refs_filt, n: int):
    """All 35 modes' predictions and SATD costs for a batch of blocks:
    (preds (m, 35, n, n) uint8, costs (m, 35) int32).  At n = 32 the sweep
    is the constant matrix product (kernels.intra_matrix), otherwise each
    mode's ops.pred_intra with the edge filter below 32."""
    m = blocks.shape[0]
    if n == 32:
        preds = pred_intra_all_modes_mm(*refs_plain, *refs_filt, n)
    else:
        preds = torch.stack(
            [pred_intra(mode, *(refs_filt if filter_flag(mode, n) else refs_plain), n,
                        filter_edge=n < 32)
             for mode in range(35)], dim=1)
    tiled = blocks[:, None].expand(m, 35, n, n).reshape(-1, n, n)
    costs = _satd_cost(tiled, preds.reshape(-1, n, n)).reshape(m, 35)
    return preds, costs


def _intra_mode_decide(blocks, refs_plain, refs_filt, n: int):
    """Mode decision and winning prediction for a batch of blocks: (pred
    (m, n, n) uint8, best (m,) int32, the first minimum).  At n = 32 the
    decision runs in the Hadamard domain (kernels.intra_matrix.
    intra_mode_decision_t, as in hevcasm_tpu: near-ties may resolve to
    another mode than the classic SATD sweep, while the chosen mode's
    prediction is exact); other sizes run the sweep with classic SATD."""
    if n == 32:
        pred, best, _ = intra_mode_decision_t(blocks, *refs_plain, *refs_filt, n)
        return pred, best
    preds, costs = _intra_mode_sweep(blocks, refs_plain, refs_filt, n)
    best, _ = first_min(costs)
    pred = torch.gather(preds, 1, best.long()[:, None, None, None].expand(-1, 1, n, n))[:, 0]
    return pred, best


def _prepare_plane(x, device=None) -> torch.Tensor:
    """An (H, W) uint8 plane as a tensor on its entry device."""
    x = as_tensor(x, entry_device(x, device))
    if x.dim() != 2 or x.dtype != torch.uint8:
        raise ValueError(f"expected an (H, W) uint8 plane, got {tuple(x.shape)} {x.dtype}")
    return x


def _prepare_frames(frames, device=None) -> torch.Tensor:
    """A (T, H, W) uint8 stack of luma frames as a tensor on its entry
    device."""
    frames = as_tensor(frames, entry_device(frames, device))
    if frames.dim() != 3 or frames.dtype != torch.uint8:
        raise ValueError(f"frames must be (T, H, W) uint8, got {tuple(frames.shape)} "
                         f"{frames.dtype}")
    return frames


def encode_intra_frame(cur, cfg: EncodeConfig = EncodeConfig(), tiers: Tier = Tier.ALL,
                       device=None) -> dict:
    """Encode one intra (I) frame: the 35-mode prediction of every
    cfg.intra_block block from open-loop neighbours (the source's samples),
    the mode decision (_intra_mode_decide), then the TU pipeline (the
    DST-VII at 4x4 TUs).

    cur: (H, W) uint8 tensor or numpy array, H and W multiples of
    cfg.intra_block; devices as for encode_inter_frame.  No registry kernel
    runs: the mode decision is plain PyTorch (float64 matrix products at n
    = 32).  Returns {"recon": (H, W) uint8, "modes": (m,) int32 in
    row-major block order, "nnz": () int32, "psnr_db": () float32}."""
    cur = _prepare_plane(cur, device)
    n = cfg.intra_block
    blocks = ctu_mod.tile_frame(cur, n)
    refs_plain, refs_filt = _prepare_intra_refs(*_intra_neighbours(cur, n), n, cfg)
    pred, best = _intra_mode_decide(blocks, refs_plain, refs_filt, n)
    rec_blocks, nnz, _ = _residual_pipeline(blocks, pred, cfg, intra=True, tiers=tiers)
    recon = ctu_mod.untile_frame(rec_blocks, *cur.shape)
    return {"recon": recon, "modes": best, "nnz": nnz, "psnr_db": psnr(cur, recon)}


def encode_gop(frames, cfg: EncodeConfig = EncodeConfig(), tiers: Tier = Tier.ALL,
               device=None) -> dict:
    """Encode an IPPP GOP in open loop: frame 0 intra (the wavefront frame
    under cfg.intra_mode="wavefront", else encode_intra_frame), frame t > 0
    predicted from source frame t - 1 (encode_inter_frame).

    frames: (T, H, W) uint8 tensor or numpy array; devices as for
    encode_inter_frame.  Returns {"recon": (T, H, W) uint8, "psnr_db": ()
    float32 over the GOP, "nnz": int, the coded coefficients of every
    frame, read from the card once}."""
    frames = _prepare_frames(frames, device)
    if cfg.intra_mode == "wavefront":
        from .intra_wavefront import encode_intra_frame_wavefront

        intra = encode_intra_frame_wavefront(frames[0], cfg, tiers)
    else:
        intra = encode_intra_frame(frames[0], cfg, tiers)
    results = [intra] + [encode_inter_frame(frames[t], frames[t - 1], cfg, tiers)
                         for t in range(1, frames.shape[0])]
    recon = torch.stack([r["recon"] for r in results])
    nnz = torch.stack([r["nnz"] for r in results]).sum(dtype=torch.int64)
    return {"recon": recon, "psnr_db": psnr(frames, recon), "nnz": int(nnz)}
