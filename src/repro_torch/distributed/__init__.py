"""Distributed training pieces of the port (reference:
``repro/distributed``): gradient compression (``collectives``), the
logical-axis sharding rules (``sharding``) and, new to the port, the
``torch.distributed`` transport of the pipelined step (``transport``)."""
