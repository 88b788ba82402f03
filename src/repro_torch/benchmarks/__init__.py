"""The paper's figures, the harness benches and the roofline on the port.
Reference: ``benchmarks/`` (``common.py``, ``bench_straggler.py``,
``bench_layer_staleness.py``, ``bench_iterations_vs_n.py``,
``bench_time_to_converge.py``, ``bench_staleness.py``,
``bench_lr_sweep.py``, ``bench_sync_vs_async.py``, ``bench_event_loop.py``,
``bench_spmd.py``, ``check_spmd_regression.py``, ``bench_recovery.py``,
``bench_serve.py``, ``bench_obs.py``, ``bench_step_time.py``,
``bench_router.py``, ``bench_loop_overhead.py``, ``roofline.py``,
``run.py``).

Each script prints its rows; a harness bench returns the reference's
payload and writes it only to ``--out PATH``. Run them all with
``python -m repro_torch.benchmarks.run [--device cpu]``.
"""
