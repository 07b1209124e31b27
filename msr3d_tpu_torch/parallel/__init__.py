"""Parallelism of the port: data parallelism over ``torch.distributed``
(``mesh.py``). tp, pp and sp are not ported yet (ROADMAP.md, queue:
parallelism)."""
