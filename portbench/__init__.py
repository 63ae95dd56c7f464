"""The benchmark of multiverso_tpu_torch (see ``portbench/run.py``)."""
