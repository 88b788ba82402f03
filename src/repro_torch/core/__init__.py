"""Host-side pieces of ``repro.core`` that the ported serve path needs."""
