"""Data parallelism on ``torch.distributed``: one rank per card (``mesh``)
and the multi-process launcher (``launcher``)."""
