"""Parallelism of the port over ``torch.distributed``: the dp × tp × pp mesh
of process groups (``mesh.py``), the megatron layout of the LLM over the tp
ranks (``sharding.py``) and its collectives (``tensor_parallel.py``), and
the pipeline of its blocks over the pp ranks (``pipeline.py``,
``llm_pp.py``). sp is not ported yet (ROADMAP.md, queue: parallelism)."""
