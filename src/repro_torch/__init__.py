"""PyTorch/CUDA port of the ``repro`` package, grown slice by slice.

Reference: ``src/repro/``. Each module here names the JAX module it
ports; the tests (``tests/test_torch_*.py``) hold it to that reference on
the same inputs. The port imports ``torch``, ``numpy`` and the standard
library only, never ``jax`` or ``repro``.

Slice 1 (this package as it stands) is the paged serve path for the dense
transformer family: ``repro_torch.serve.ServeEngine`` over
``repro_torch.models.TransformerLM``, with hand-written Hopper kernels for
the page gather and for prefill's flash attention
(``repro_torch/kernels/csrc/``).
"""
