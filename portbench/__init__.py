"""The benchmark of ``dmip_tpu_torch`` on one NVIDIA GPU.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints its result
as the last line of standard output.  Everything that measures or judges
the program lives here: the traffic drivers (``drivers/``), the
configurations (``configs/``) and traffic mixes (``traffic/``) as data,
one reader a per-layer metric (``metrics/``), the operation counts and
peaks (``flops.py``), the trace reduction (``trace.py``) and the plain
reference (``reference/``), which imports nothing of the program.
"""
