"""The port's benchmark: ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the repository's root (``BENCHMARK.json``
names the cells). ``portbench/tests`` holds its CPU tests."""
