"""The benchmark of relgat_projector_tpu_torch (``benchmark/run.py``)."""
