"""The benchmark of the PyTorch and CUDA port (``gear_tpu_torch``) on the H100:
run one cell with ``python3 portbench/run.py --workload NAME --seed N
--seconds S --trace 0|1`` (see ``run.py``)."""
