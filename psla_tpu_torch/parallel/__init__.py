"""Several models trained as one (port of ``psla_tpu/parallel``): the
multi-seed ensemble on one card (ensemble.py). Data parallelism across
cards (``mesh.py``, ``distributed.py``) waits for ROADMAP.md, Queue 1,
item 6."""
