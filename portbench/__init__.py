"""The benchmark of ``sesam_duke_microservice_tpu_torch`` (``run.py``)."""
