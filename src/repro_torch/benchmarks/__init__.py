"""The paper's convergence experiments on the port.
Reference: ``benchmarks/`` (``common.py``, ``bench_iterations_vs_n.py``,
``bench_time_to_converge.py``, ``bench_sync_vs_async.py``, ``run.py``).

Each script prints its rows and writes no file. Run them all with
``python -m repro_torch.benchmarks.run [--device cpu]``.
"""
