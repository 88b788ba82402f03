"""The paper's coordination layer: straggler models, the mask strategies
and their registry, the straggler simulator, the masked loss and EMA.
Reference: ``src/repro/core/``."""
