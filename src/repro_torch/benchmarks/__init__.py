"""The paper's figures and the roofline on the port.
Reference: ``benchmarks/`` (``common.py``, ``bench_straggler.py``,
``bench_layer_staleness.py``, ``bench_iterations_vs_n.py``,
``bench_time_to_converge.py``, ``bench_staleness.py``,
``bench_lr_sweep.py``, ``bench_sync_vs_async.py``, ``roofline.py``,
``run.py``).

Each script prints its rows and writes no file. Run the figures with
``python -m repro_torch.benchmarks.run [--device cpu]``.
"""
