"""Parallelism of the port over ``torch.distributed``: the dp × tp × pp × sp
mesh of process groups (``mesh.py``), the megatron layout of the LLM over the
tp ranks (``sharding.py``) and its collectives (``tensor_parallel.py``), the
pipeline of its blocks over the pp ranks (``pipeline.py``, ``llm_pp.py``),
and ring attention over the sequence blocks of the sp ranks
(``ring_attention.py``)."""
