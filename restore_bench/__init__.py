"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of ReStore.

One run measures one cell (a configuration under a traffic mix) on the
CUDA card: ``python restore_bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``, from the root of a checkout.  Everything
a cell needs is found by name: ``BENCHMARK.json`` at the root lists the
cells and metrics, ``configs/<config>.json`` holds a configuration,
``workloads/<cell>.json`` its traffic, ``drivers/<driver>.py`` the loop
that offers the traffic, and ``metrics/<metric>.py`` the reader of one
metric.  ``yardstick/`` and ``reference/`` are frozen copies of the
generators, the cost formulas and the plain references the verdict rests
on; none of them imports the program.
"""
