"""Kernel intra_wave_fused: one wave of the closed-loop I frame in one
launch.

It replaces no TPU kernel: hevcasm_tpu codes the wavefront I frame in plain
ops, a wave at a time, and so did the port, some 200 small torch launches a
wave (the neighbour gather, substitution and smoothing, the 35-mode
decision as float64 products against a 258 x 35,840 weight matrix, the 8x8
residual, the scatter into the canvas), each waiting on the host's enqueue.
``csrc/intra_wave.cu`` computes the same integers in one launch a wave: a
CTA a 32x32 block reads its neighbours from the tiled canvas, substitutes
and smooths them, scores the 35 modes in the Hadamard domain on the CUDA
cores (the accumulators kernels.intra_matrix's columns give, no matrix),
predicts the winner, codes it at 8x8 TUs on the residual stage K2, B3, B4
and B19 share (``csrc/residual_core.cuh``), and writes the reconstruction
back into the canvas and its nnz into the frame's count; the header says
what bounds it on the card.  Beside it stands its plain version,
``intra_wave_ref``: the per-wave composition the wavefront loop ran.

Contract: ``intra_wave_fused(canvas, src, order, refs, lav, aav, cav, s, e,
nnz, cfg, modes=None)`` codes blocks s..e-1 of the wave tables
(``encode.intra_wavefront._schedule``: order (num,) int64 tile indices,
refs (num, 4n + 1) int64 canvas offsets, lav / aav (num, 2n) and cav (num,)
bool availability) in place: canvas, the (H W,) uint8 tiled
reconstruction, gets their tiles; nnz, a () int32 tensor, is added their
coded coefficients; modes, an optional (num,) int32 tensor, gets their
modes.  src is (num, n, n) uint8, the source blocks in wave order; cfg
gives n (``intra_block``, 32), the TU size (8) and the intra quantizer.

It is the KERNEL tier of the registry's ``intra_wave``, whose REF tier is
the plain version; encode.intra_wavefront takes it for CUDA planes at 32x32
blocks and 8x8 TUs when the tiers include KERNEL.
"""

from __future__ import annotations

import functools
import struct

import torch

from .. import registry
from ..config import Tier
from ..ops.quantize import check_quant_params
from . import build

__all__ = ["intra_wave_fused", "intra_wave_ref", "BLOCK", "TU"]

BLOCK = 32                          # the block side the kernel codes
TU = 8                              # and its TU size
_ARGS = struct.Struct("20q")        # csrc/intra_wave.cu IntraWaveArgs
_U8, _I32, _I64, _BOOL = torch.uint8, torch.int32, torch.int64, torch.bool


def intra_wave_ref(canvas, src, order, refs, lav, aav, cav, s, e, nnz, cfg, modes=None,
                   tiers: Tier = Tier.REF):
    """Plain version: the wave's neighbour gather, loop._prepare_intra_refs,
    loop._intra_mode_decide and loop._residual_pipeline (at ``tiers``), the
    tiles written back with index_copy_."""
    from ..encode.loop import _intra_mode_decide, _prepare_intra_refs, _residual_pipeline

    n = cfg.intra_block
    nb = canvas.index_select(0, refs[s:e].reshape(-1)).view(e - s, 4 * n + 1)
    refs_plain, refs_filt = _prepare_intra_refs(
        nb[:, :2 * n], nb[:, 2 * n:4 * n], nb[:, 4 * n], lav[s:e], aav[s:e], cav[s:e], n, cfg)
    pred, best = _intra_mode_decide(src[s:e], refs_plain, refs_filt, n)
    rec, nnz_w, _ = _residual_pipeline(src[s:e], pred, cfg, intra=True, tiers=tiers)
    canvas.view(-1, n, n).index_copy_(0, order[s:e], rec)
    nnz.add_(nnz_w)
    if modes is not None:
        modes[s:e] = best


@functools.lru_cache(maxsize=None)
def _qargs(qp: int) -> tuple:
    """The intra quantizer (qscale, qshift, qoffset, dscale, dshift) of qp
    ``qp`` at 8x8 TUs as host ints."""
    from ..encode.loop import EncodeConfig

    cfg = EncodeConfig(qp=qp, tu=TU)
    q = (*cfg.quant_params(intra=True), *cfg.dequant_params())
    check_quant_params(*q[:3])
    return q


def _layout_ok(card, canvas, src, order, refs, lav, aav, cav, nnz, modes) -> bool:
    """Whether the operands are what the kernel reads as it reads them: one
    card, contiguous, the tables of one length, canvas and src 16-byte
    aligned."""
    num = order.shape[0] if order.dim() == 1 else -1
    want = ((canvas, _U8, None), (src, _U8, (num, BLOCK, BLOCK)), (order, _I64, (num,)),
            (refs, _I64, (num, 4 * BLOCK + 1)), (lav, _BOOL, (num, 2 * BLOCK)),
            (aav, _BOOL, (num, 2 * BLOCK)), (cav, _BOOL, (num,)), (nnz, _I32, ()))
    if modes is not None:
        want += ((modes, _I32, (num,)),)
    for t, dtype, shape in want:
        if type(t) is not torch.Tensor or t.dtype is not dtype or t.get_device() != card \
                or not t.is_contiguous() or (shape is not None and t.shape != shape):
            return False
    return (canvas.dim() == 1 and canvas.numel() % (BLOCK * BLOCK) == 0
            and not canvas.data_ptr() & 15 and not src.data_ptr() & 15)


def _launch(canvas, src, order, refs, lav, aav, cav, s, e, nnz, cfg, modes):
    what = "intra_wave_fused"
    if cfg.intra_block != BLOCK or cfg.tu != TU:
        raise ValueError(f"{what}: {cfg.intra_block}x{cfg.intra_block} blocks at {cfg.tu}x"
                         f"{cfg.tu} TUs; the kernel codes {BLOCK}x{BLOCK} blocks at {TU}x{TU}")
    ops = (canvas, src, order, refs, lav, aav, cav, nnz, modes)
    card = build.on_card(what, *(t for t in ops if t is not None)).index
    if not _layout_ok(card, *ops):
        raise ValueError(f"{what}: operands not in the layout of the wave tables "
                         "(encode.intra_wavefront._schedule; canvas and src 16-byte aligned)")
    num = order.shape[0]
    if not 0 <= s < e <= num:
        raise ValueError(f"{what}: span [{s}, {e}) outside the {num} blocks")
    err = build.load().hevc_intra_wave(_ARGS.pack(
        *(0 if t is None else t.data_ptr() for t in ops), s, e, num,
        int(cfg.strong_intra_smoothing), *_qargs(cfg.qp), card, build.raw_stream(card)))
    build.check(err, what)


def intra_wave_fused(canvas, src, order, refs, lav, aav, cav, s, e, nnz, cfg, modes=None):
    """Code blocks s..e-1 of the wave tables into canvas, nnz (and modes).
    CPU tensors run the plain version; CUDA tensors launch the kernel (and
    raise if it cannot be built or launched, or the operands are ones it
    does not take)."""
    if canvas.device.type == "cpu":
        return intra_wave_ref(canvas, src, order, refs, lav, aav, cav, s, e, nnz, cfg, modes)
    _launch(canvas, src, order, refs, lav, aav, cav, s, e, nnz, cfg, modes)
    intra_wave_fused.launches += 1


intra_wave_fused.launches = 0

registry.register("intra_wave", Tier.REF, intra_wave_ref)
registry.register("intra_wave", Tier.KERNEL, intra_wave_fused)
