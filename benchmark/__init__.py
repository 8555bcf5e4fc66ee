"""The benchmark of the PyTorch/CUDA port (``fspt_tpu_torch``): see
README.md.  ``python3 benchmark/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell."""
