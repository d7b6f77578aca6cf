"""The benchmark of zrenderer_tpu_torch (``perfbench/run.py``)."""
