import os
import sys

# NOTE: deliberately NO xla_force_host_platform_device_count here — tests
# see the real single device; multi-device semantics are exercised via
# subprocess tests (test_spmd_subprocess.py) per the dry-run contract.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# repo root, so tests can reuse benchmark helpers (benchmarks.common)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the port's CUDA kernels); "
        "skipped where torch.cuda.is_available() is false")
