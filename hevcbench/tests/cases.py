"""The cells at a tiny size, shared by the benchmark's CPU tests."""

#: Every cell at a size the CPU codes in about a second: 256x128 frames
#: (coded from 120 rows), R = 8, a pool of 8 frames, GOPs of 4.
TINY = {"config": {"width": 256, "height": 120, "coded_height": 128,
                   "encode": {"search_range": 8}},
        "mix": {"content": {"frames": 8}, "warmup_steps": 2, "trace_steps": 2,
                "check_pairs": 2, "gop": 4, "check_gops": 1}}

CELLS = ("ldp1080_live", "uhd_gop32_closed", "uhd_p_live")

