"""Multi-device encode over torch.distributed: the data-parallel GOP and
CTU-row bands with halo exchange (sharding), process bring-up and the
global mesh (multihost), a launcher of N-rank worlds (launch), the dry run
(dryrun) and the scaling harness (scaling)."""

from .sharding import (
    make_mesh,
    encode_p_frames_batch,
    encode_gop_data_parallel,
    encode_inter_frame_spatial,
    encode_gop_closed_loop_spatial,
)

__all__ = [
    "make_mesh",
    "encode_p_frames_batch",
    "encode_gop_data_parallel",
    "encode_inter_frame_spatial",
    "encode_gop_closed_loop_spatial",
]
