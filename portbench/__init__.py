"""The benchmark of pffft_tpu_torch: streamed FIR and channelizer cells, one process a card.

Run one cell with ``python3 -m portbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; the cells, the
metrics and the run length are in ``BENCHMARK.json``.
"""
