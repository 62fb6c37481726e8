"""Multi-device sharding of the encode loop over torch.distributed, the
counterpart of ``hevcasm_tpu.parallel.sharding``.

Two mesh axes:

* ``frames`` (data parallel): open-loop IPPP makes every P frame depend
  only on source frames, so a GOP's P frames split into contiguous chunks,
  one a ``frames`` coordinate; the outputs are all-gathered.

* ``rows`` (spatial): a frame's CTU-row bands split over ranks; each band
  needs (search range + filter pad) reference rows of its neighbours, its
  halo, exchanged with paired batch_isend_irecv.  The result equals the
  single-device encode bit for bit.

Every entry is called on every rank of the mesh with the same global
input.  A rank reads only its own share of it (its chunk of frames or its
band), plus the halo rows it receives, and every rank returns the same
dict as hevcasm_tpu's function, with the same keys, dtypes and shapes, on
its own device.  A rank outside the mesh returns None.  A group of one rank
exchanges and gathers nothing, as one JAX device does not.  Under nccl the
exchanged rows and gathered outputs stay on the card; gloo's collectives
take host memory only, so under gloo they cross through host copies
(``_on_wire``), while the computation stays on the rank's device.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import Tier
from ..encode import ctu as ctu_mod
from ..encode import motion
from ..encode.intra_wavefront import encode_intra_frame_wavefront
from ..encode.loop import (EncodeConfig, _check_inter_core, _inter_core, _prepare_frames,
                           _prepare_plane, encode_inter_frame)
from ..utils.tensor import as_tensor
from . import multihost

__all__ = [
    "make_mesh",
    "encode_p_frames_batch",
    "encode_gop_data_parallel",
    "encode_inter_frame_spatial",
    "encode_gop_closed_loop_spatial",
]


@dataclasses.dataclass
class WireStats:
    """What crossed between ranks since the last reset: halo bytes sent,
    gathered bytes received, and the host seconds spent copying buffers to
    and from host memory for gloo."""

    halo_bytes: int = 0
    gathered_bytes: int = 0
    host_copy_s: float = 0.0


#: This process's WireStats; chip_smoke reads and resets it.
wire = WireStats()


def reset_wire_stats() -> None:
    global wire
    wire = WireStats()


def _on_wire(t: torch.Tensor, group) -> torch.Tensor:
    """The buffer a collective of ``group`` takes for ``t``: under gloo a
    contiguous host copy (gloo moves host memory only), under nccl t
    itself, made contiguous, on its card."""
    if dist.get_backend(group) != "gloo" or t.device.type == "cpu":
        return t.contiguous()
    t0 = time.perf_counter()
    host = t.cpu()
    wire.host_copy_s += time.perf_counter() - t0
    return host


def _wire_empty(rows: int, like: torch.Tensor, group) -> torch.Tensor:
    """A receive buffer of ``rows`` rows of ``like``, where _on_wire puts
    a send buffer."""
    dev = "cpu" if dist.get_backend(group) == "gloo" else like.device
    return torch.empty((rows, like.shape[1]), dtype=like.dtype, device=dev)


def _off_wire(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A received buffer back on the rank's device."""
    if t.device == device:
        return t
    t0 = time.perf_counter()
    out = t.to(device)
    wire.host_copy_s += time.perf_counter() - t0
    return out


def _all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in the
    group's rank order; a group of one moves nothing."""
    if dist.get_world_size(group) == 1:
        return t
    buf = _on_wire(t, group)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    wire.gathered_bytes += sum(p.numel() * p.element_size() for p in parts)
    return _off_wire(torch.cat(parts, dim), t.device)


def _all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    if dist.get_world_size(group) == 1:
        return t
    buf = _on_wire(t, group).clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return _off_wire(buf, t.device)


def _coordinate(mesh: DeviceMesh):
    """This rank's (frames, rows) coordinate in ``mesh``, None outside."""
    if mesh.mesh_dim_names != ("frames", "rows"):
        raise ValueError(f"mesh axes {mesh.mesh_dim_names} != ('frames', 'rows')")
    return mesh.get_coordinate()


def make_mesh(frames: int = 1, rows: int = 1, ranks=None) -> DeviceMesh:
    """A (frames, rows) DeviceMesh with axis names ('frames', 'rows') over
    the world's ranks, or over ``ranks`` (the counterpart of hevcasm_tpu's
    ``devices=``; ranks outside it return None from the entries).  Every
    rank of the world calls it.  ``frames * rows`` must equal the number of
    ranks (hevcasm_tpu takes the first frames * rows devices; the port
    asks for the ranks by name), else ValueError.  The mesh's device type
    is that of the rank's device."""
    if ranks is None:
        ranks = range(multihost.world_size())
    return multihost.mesh_over(ranks, frames, rows)


def encode_p_frames_batch(curs, refs, cfg: EncodeConfig = EncodeConfig(),
                          tiers: Tier = Tier.ALL, device=None) -> dict:
    """encode_inter_frame over a leading frame axis: frame t of ``curs``
    against frame t of ``refs``, both (T, H, W) uint8 tensors or numpy
    arrays (devices as for encode_inter_frame).  Every key of the
    per-frame dict is stacked along a new leading axis, as hevcasm_tpu's
    vmap gives it.  Needs no process group."""
    curs = _prepare_frames(curs, device)
    refs = as_tensor(refs, curs.device)
    if refs.shape != curs.shape or refs.dtype != curs.dtype:
        raise ValueError(f"refs {tuple(refs.shape)} {refs.dtype} must match curs "
                         f"{tuple(curs.shape)} {curs.dtype}")
    if curs.shape[0] < 1:
        raise ValueError("encode_p_frames_batch needs at least one frame")
    outs = [encode_inter_frame(c, r, cfg, tiers) for c, r in zip(curs, refs)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def encode_gop_data_parallel(frames, mesh: DeviceMesh, cfg: EncodeConfig = EncodeConfig(),
                             tiers: Tier = Tier.ALL, device=None) -> dict | None:
    """BASELINE config 4: an open-loop IPPP GOP with its P frames 1..T-1
    split into contiguous chunks over the mesh's ``frames`` axis.

    frames: (T, H, W) uint8, the same on every rank; (T - 1) must divide by
    the axis size, else ValueError.  Each rank reads its chunk's frames and
    the reference before them and encodes them (ranks that differ only in
    ``rows`` encode the same chunk, as hevcasm_tpu replicates it); the
    outputs are all-gathered over ``frames``.  Returns
    encode_p_frames_batch's dict for frames 1..T-1 on every rank of the
    mesh (recon (T-1, H, W), mvs, sad, nnz, psnr_db, ...), None outside."""
    coord = _coordinate(mesh)
    t = int(frames.shape[0])
    nf = mesh.size(0)
    if t < 2 or (t - 1) % nf:
        raise ValueError(f"{t - 1} P frames do not split over {nf} 'frames' ranks")
    if coord is None:
        return None
    chunk = (t - 1) // nf
    lo = coord[0] * chunk
    share = _prepare_frames(frames[lo:lo + chunk + 1], device)
    out = encode_p_frames_batch(share[1:], share[:-1], cfg, tiers)
    group = mesh.get_group("frames")
    return {k: _all_gather_cat(v, group) for k, v in out.items()}


def _exchange_halo(band: torch.Tensor, top: int, bottom: int, group) -> torch.Tensor:
    """The band with ``top`` rows above and ``bottom`` rows below: the upper
    neighbour's last ``top`` rows and the lower neighbour's first
    ``bottom``, exchanged in one batch of paired isend/irecv (no order can
    deadlock).  The first and last bands replicate their own edge rows,
    as pad_frame's edge mode does; a group of one band only replicates.
    A halo taller than the band (it would need rows of a band further
    away) raises ValueError on every rank, before any exchange."""
    n = dist.get_world_size(group)
    h = band.shape[0]
    if n > 1 and max(top, bottom) > h:
        raise ValueError(f"halo of {top}/{bottom} rows is taller than a band of {h} rows")
    idx = dist.get_rank(group)
    peers = dist.get_process_group_ranks(group)
    top_rows = band[:1].expand(top, -1)
    bot_rows = band[-1:].expand(bottom, -1)
    if n > 1:
        ops, recv = [], {}
        if idx > 0:
            recv["top"] = _wire_empty(top, band, group)
            ops += [dist.P2POp(dist.isend, _on_wire(band[:bottom], group), peers[idx - 1],
                               group),
                    dist.P2POp(dist.irecv, recv["top"], peers[idx - 1], group)]
        if idx < n - 1:
            recv["bot"] = _wire_empty(bottom, band, group)
            ops += [dist.P2POp(dist.isend, _on_wire(band[-top:], group), peers[idx + 1],
                               group),
                    dist.P2POp(dist.irecv, recv["bot"], peers[idx + 1], group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        wire.halo_bytes += band.shape[1] * ((bottom if idx > 0 else 0)
                                            + (top if idx < n - 1 else 0))
        if "top" in recv:
            top_rows = _off_wire(recv["top"], band.device)
        if "bot" in recv:
            bot_rows = _off_wire(recv["bot"], band.device)
    return torch.cat([top_rows, band, bot_rows], dim=0)


def _check_spatial(cfg: EncodeConfig, h: int, nrows: int) -> int:
    """What the spatial entries refuse, before any exchange; returns the
    band height."""
    if cfg.me_strategy == "pyramid":
        # The coarse level would decimate the halo-extended band with
        # band-local positions, silently wrong across band edges.
        raise ValueError("spatial sharding supports me_strategy='full' only")
    _check_inter_core(cfg)
    band_h = h // nrows
    if band_h * nrows != h or band_h % cfg.ctu:
        raise ValueError(f"{h} rows do not split into {nrows} bands of whole "
                         f"{cfg.ctu}-row CTUs")
    return band_h


def _band_frame_step(cur_band, ref_band, cfg: EncodeConfig, h: int, group,
                     tiers: Tier = Tier.ALL):
    """One inter frame on this rank's CTU-row band: the halo exchange, the
    horizontal edge pad, then the same cfg-selected engine as one device
    (loop._inter_core: K1 and K2 under fused_dma, B16 under fused /
    fused_batched, B11 and B4 under fused_refine / residual_impl="pallas",
    the staged path under mega, as in hevcasm_tpu) on the band's padded
    plane with band-local CTU positions.  Returns (recon band, best (n_band,)
    int32, nnz () int32 summed over the bands, psnr_db () float32 of the
    whole frame from the exact SSE summed over the bands)."""
    band_h, w = cur_band.shape
    r = cfg.search_range
    halo_t, halo_b = r + motion.PAD_L, r + motion.PAD_R
    ref_v = _exchange_halo(ref_band, halo_t, halo_b, group)
    ref_padded = ctu_mod.pad_frame(ref_v, 0, 0, halo_t, halo_b)
    grid = ctu_mod.grid_shape(band_h, w, cfg.ctu)
    src_ctus = ctu_mod.tile_frame(cur_band, cfg.ctu).contiguous()
    pos = motion.ctu_positions(*grid, cfg.ctu, cur_band.device)
    rec_ctus, _, best, nnz = _inter_core(src_ctus, ref_padded, pos, cfg, grid, tiers)
    recon = ctu_mod.untile_frame(rec_ctus, band_h, w)
    d = cur_band.to(torch.int64) - recon.to(torch.int64)
    sse = _all_reduce_sum((d * d).sum(), group)
    nnz = _all_reduce_sum(nnz, group)
    return recon, best, nnz, _psnr_of_sse(sse, h * w)


def _psnr_of_sse(sse: torch.Tensor, count: int, bit_depth: int = 8) -> torch.Tensor:
    """utils.psnr's value from an exact int64 SSE over ``count`` samples."""
    mse = (sse.to(torch.float64) / count).clamp_min(1e-10)
    peak = float((1 << bit_depth) - 1)
    return (10.0 * torch.log10(peak * peak / mse)).to(torch.float32)


def encode_inter_frame_spatial(cur, ref, mesh: DeviceMesh, cfg: EncodeConfig = EncodeConfig(),
                               tiers: Tier = Tier.ALL, device=None) -> dict | None:
    """BASELINE config 5's step: one inter frame with its CTU-row bands
    over the mesh's ``rows`` axis and reference halos exchanged between
    neighbours.

    cur, ref: (H, W) uint8, the same on every rank (tensors or numpy;
    devices as for encode_inter_frame); H must split into
    mesh.size("rows") bands of whole CTUs, else ValueError.  Each rank
    reads only its band of each.  Returns {"recon": (H, W) uint8, "sad":
    (n,) int32 in the global CTU order, "nnz": () int32, "psnr_db": ()
    float32} on every rank of the mesh, equal to encode_inter_frame's (no
    "mvs", as hevcasm_tpu's out_specs), None outside."""
    coord = _coordinate(mesh)
    h, w = cur.shape
    nrows = mesh.size(1)
    band_h = _check_spatial(cfg, h, nrows)
    if coord is None:
        return None
    lo = coord[1] * band_h
    cur_band = _prepare_plane(cur[lo:lo + band_h], device)
    ref_band = as_tensor(ref[lo:lo + band_h], cur_band.device)
    if tuple(ref.shape) != (h, w) or ref_band.dtype != torch.uint8:
        raise ValueError("cur and ref must be (H, W) uint8 planes of one shape")
    group = mesh.get_group("rows")
    recon, best, nnz, psnr_db = _band_frame_step(cur_band, ref_band, cfg, h, group, tiers)
    return {"recon": _all_gather_cat(recon, group), "sad": _all_gather_cat(best, group),
            "nnz": nnz, "psnr_db": psnr_db}


def encode_gop_closed_loop_spatial(frames_y, mesh: DeviceMesh,
                                   cfg: EncodeConfig = EncodeConfig(),
                                   tiers: Tier = Tier.ALL, device=None) -> dict | None:
    """BASELINE config 5: a closed-loop IPPP GOP (each P frame predicted
    from the previous frame's reconstruction) with every frame's CTU-row
    bands over the mesh's ``rows`` axis.

    frames_y: (T, H, W) uint8, the same on every rank; H as for
    encode_inter_frame_spatial (else ValueError).  Every rank codes the I
    frame whole with encode_intra_frame_wavefront (its wave schedule is
    sequential; hevcasm_tpu replicates it too) and keeps its band; each P
    frame then exchanges the halo of the previous reconstruction of the
    band, so only boundary rows cross between ranks until the bands are
    gathered at the end.  Returns {"recon": (T, H, W) uint8 with the I frame
    first, "psnr_db": (T,) float32}, equal to encode_gop_closed_loop's, on
    every rank of the mesh, None outside."""
    coord = _coordinate(mesh)
    t, h, w = frames_y.shape
    band_h = _check_spatial(cfg, h, mesh.size(1))
    if coord is None:
        return None
    intra = encode_intra_frame_wavefront(_prepare_plane(frames_y[0], device), cfg, tiers)
    dev = intra["recon"].device
    lo = coord[1] * band_h
    group = mesh.get_group("rows")
    prev = intra["recon"][lo:lo + band_h]
    recs, psnrs = [], [intra["psnr_db"]]
    for k in range(1, t):
        cur_band = as_tensor(frames_y[k, lo:lo + band_h], dev)
        prev, _, _, psnr_db = _band_frame_step(cur_band, prev, cfg, h, group, tiers)
        recs.append(prev)
        psnrs.append(psnr_db)
    recon = intra["recon"][None]
    if recs:
        recon = torch.cat([recon, _all_gather_cat(torch.stack(recs), group, dim=1)])
    return {"recon": recon, "psnr_db": torch.stack(psnrs)}
