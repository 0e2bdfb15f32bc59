"""Distributed training pieces of the port (reference:
``repro/distributed``): gradient compression (``collectives``)."""
