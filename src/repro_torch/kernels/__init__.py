"""Hand-written Hopper kernels of the port, each beside its plain version.

Reference: ``src/repro/kernels/`` (Pallas TPU kernels). Sources are under
``csrc/`` and are built by ``_build`` at first use on the card.
"""
