"""The benchmark of ic_gvins_tpu_torch: ``python3 gvbench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` (see ``run.py``)."""
