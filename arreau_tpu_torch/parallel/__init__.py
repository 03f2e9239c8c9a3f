"""Data and tensor parallelism of the port (``mesh.py``)."""
