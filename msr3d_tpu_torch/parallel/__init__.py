"""Parallelism of the port over ``torch.distributed``: the dp × tp mesh of
process groups (``mesh.py``), the megatron layout of the LLM over the tp
ranks (``sharding.py``) and its collectives (``tensor_parallel.py``). pp and
sp are not ported yet (ROADMAP.md, queue: parallelism)."""
