"""The device mesh of the port: SPMD over ``torch.distributed``, one process
per card (``sharded.py``)."""

from .sharded import make_mesh

__all__ = ["make_mesh"]
