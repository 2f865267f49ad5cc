"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``) on an
NVIDIA H100: ``python3 cardbench/run.py --workload <cell> ...``.  See
``run.py`` for a run, ``bench.py`` for how a cell's files are found."""
