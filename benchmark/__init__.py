"""The benchmark of nero_tpu_torch: Stage-I training throughput on one card.

`python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
(see README.md). Everything here is the yardstick: the traffic and
configuration files, the plain reference that decides `correct`, the
algorithmic work counts and the per-layer metric readers.
"""
