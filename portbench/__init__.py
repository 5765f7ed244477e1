"""The benchmark of ``codec_eval_tpu_torch`` on an NVIDIA H100: one cell
per run, ``python3 -m portbench.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``."""
