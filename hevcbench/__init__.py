"""hevcbench: the end-to-end benchmark of hevcasm_tpu_torch on one NVIDIA
H100.  ``python3 hevcbench/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``; see README.md."""
