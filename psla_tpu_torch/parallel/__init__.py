"""Several cards and several models trained as one (port of
``psla_tpu/parallel``): data parallelism over the ranks of a
``torch.distributed`` group (``mesh.py``, ``distributed.py``), and the
multi-seed ensemble (``ensemble.py``), on one card or its members spread
over rows of ranks."""
