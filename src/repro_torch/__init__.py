"""PyTorch/CUDA port of the ``repro`` package, grown slice by slice.

Reference: ``src/repro/``. Each module here names the JAX module it
ports; the tests (``tests/test_torch_*.py``) hold it to that reference on
the same inputs. The port imports ``torch``, ``numpy`` and the standard
library only, never ``jax`` or ``repro``.

Slice 1 is the paged serve path for the dense transformer family:
``repro_torch.serve.ServeEngine`` over ``repro_torch.models.TransformerLM``,
with hand-written Hopper kernels for the page gather and for prefill's
flash attention. Slice 2 is the paper's backup-worker training path:
``repro_torch.train.loop.run_experiment`` with the mask strategies on the
``sim`` backend and on the ``spmd`` engine at mesh 1 x 1, whose masked
mean of the fastest N gradients is the hand-written ``backup_reduce``
kernel. Kernel sources are under ``repro_torch/kernels/csrc/``.
"""
