"""Several cards and several models trained as one (port of
``psla_tpu/parallel``): data parallelism over the ranks of a
``torch.distributed`` group (``mesh.py``, ``distributed.py``), and the
multi-seed ensemble on one card (``ensemble.py``; members across ranks are
ROADMAP.md, Queue 1, item 6b)."""
