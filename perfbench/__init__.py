"""The benchmark of ``autodist_tpu_torch`` on NVIDIA H100 cards.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once; see README.md.
Everything the yardstick needs (traffic, FLOP and byte counts, peaks,
the plain reference, the trace reduction, the comparison that decides
``correct``) lives in this package, so a change to the program cannot
move it.
"""
