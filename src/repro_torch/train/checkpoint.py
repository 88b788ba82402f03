"""Self-healing checkpointing: atomic npz + JSON manifest, keep-k, resume.
Reference: ``src/repro/train/checkpoint.py``.

The on-disk format is the reference's, so a checkpoint written by either
package restores in the other:

    <dir>/step_<N>/arrays.npz + manifest.json, and <dir>/LATEST

* ``arrays.npz`` holds one array per leaf of the saved tree, keyed by its
  ``/``-joined path (``params/seg_dense/attn/wq/w``, ``opt/ms/...``);
  trees are the reference's, with per-layer leaves stacked ``[L, ...]``
  (``models.convert.to_jax_tree``). bf16 tensors are written as the raw
  2-byte ``|V2`` records numpy makes of the reference's bf16 arrays.
* the manifest carries the step, the array list, a CRC32 per array (over
  dtype, shape and bytes) and the trainer's metadata;
* writes go to a temporary directory that is fsynced and renamed
  atomically, retrying transient ``OSError``s with seeded, capped,
  jittered exponential backoff;
* ``restore`` verifies every array's checksum and walks back to the last
  verified-good ``step_*`` dir past corrupt ones; ``latest_step`` scans
  the step dirs when ``LATEST`` dangles.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

_BF16_RAW = np.dtype("V2")


class CheckpointCorruption(RuntimeError):
    """Raised when no verified-good checkpoint could be restored."""


def to_numpy(leaf) -> np.ndarray:
    """A tensor or array -> numpy; bf16 as its raw 2-byte records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_RAW)
        return t.numpy()
    return np.asarray(leaf)


def to_tensor(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """numpy (``|V2`` read as bf16) -> a CPU tensor of ``dtype``."""
    if arr.dtype == _BF16_RAW:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(dtype)


def _flatten_with_paths(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(tree[key], Mapping):
            flat.update(_flatten_with_paths(tree[key], path))
        else:
            flat[path] = tree[key]
    return flat


def _unflatten_like(template: Mapping, flat: Dict[str, np.ndarray],
                    prefix: str = "") -> Dict:
    out = {}
    for key, leaf in template.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(leaf, Mapping):
            out[key] = _unflatten_like(leaf, flat, path)
            continue
        if path not in flat:
            raise KeyError(f"checkpoint missing array {path!r}")
        arr = flat[path]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {path}: ckpt {arr.shape} "
                             f"vs template {tuple(leaf.shape)}")
        out[key] = to_tensor(arr, leaf.dtype)
    return out


def _checksum(arr: np.ndarray) -> str:
    """CRC32 over dtype, shape and raw bytes (cheap, catches truncation
    and bit flips — not an adversarial-integrity hash)."""
    meta = f"{arr.dtype.str}:{arr.shape}".encode()
    raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)  # no copy
    crc = zlib.crc32(memoryview(raw), zlib.crc32(meta))
    return f"crc32:{crc:08x}"


def _checksum_pool() -> ThreadPoolExecutor:
    """Threads for the checksums, which run beside the copies, writes and
    reads of the other arrays (``zlib.crc32`` releases the GIL)."""
    return ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1)))


def _read_stored(f, info: zipfile.ZipInfo) -> Optional[np.ndarray]:
    """The array of an uncompressed ``.npy`` member of the open npz file
    ``f``, read in one piece from its offset (``np.load`` reads 256 KiB at
    a time through ``zipfile``, and checks the zip's CRC, which the
    manifest's checksum repeats); None for a member it cannot take."""
    if info.compress_type != zipfile.ZIP_STORED:
        return None
    f.seek(info.header_offset)
    head = f.read(30)
    if len(head) != 30 or head[:4] != b"PK\x03\x04":
        raise zipfile.BadZipFile(f"{info.filename}: no local header")
    f.seek(info.header_offset + 30 + int.from_bytes(head[26:28], "little")
           + int.from_bytes(head[28:30], "little"))
    version = np.lib.format.read_magic(f)
    if version not in ((1, 0), (2, 0)):
        return None
    shape, fortran, dtype = (np.lib.format.read_array_header_1_0(f)
                             if version == (1, 0) else
                             np.lib.format.read_array_header_2_0(f))
    if dtype.hasobject:
        return None
    count = int(np.prod(shape, dtype=np.int64))
    arr = np.fromfile(f, dtype, count)
    if arr.size != count:
        raise EOFError(f"{info.filename}: {arr.size} of {count} items")
    return arr.reshape(shape, order="F" if fortran else "C")


def _read_npz(path: str, checked, pool: ThreadPoolExecutor
              ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """The arrays of the npz at ``path`` and futures of their checksums.
    Arrays named in ``checked`` (the manifest's checksums, which verify
    them) are read in one piece where they can be; the rest as
    ``np.load`` reads them."""
    flat, sums = {}, {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            name = info.filename
            k = name[:-4] if name.endswith(".npy") else name
            arr = _read_stored(f, info) if k in checked else None
            if arr is None:
                with zf.open(info) as m:
                    arr = np.lib.format.read_array(m)
            flat[k] = arr
            sums[k] = pool.submit(_checksum, arr)
    return flat, sums


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_attempt(tmp: str, flat: Dict[str, np.ndarray],
                   manifest: Callable[[], Dict],
                   io_check: Optional[Callable[[], None]]) -> None:
    """One durable write of arrays + manifest into ``tmp`` (no rename);
    ``manifest()`` is asked for once the arrays are written."""
    if io_check is not None:
        io_check()                 # the chaos engine's ckpt_io fault
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest(), f, indent=2, default=str)
        f.flush()
        os.fsync(f.fileno())
    _fsync_path(tmp)


def retry_delays(retries: int, backoff_s: float, *,
                 max_backoff_s: float = 0.25, jitter: float = 0.5,
                 seed: int = 0) -> List[float]:
    """The seeded retry-delay schedule ``save`` sleeps through: exponential
    backoff capped at ``max_backoff_s``, scaled by a uniform jitter in
    ``[1, 1 + jitter]``."""
    rng = np.random.RandomState(seed)
    out = []
    for attempt in range(max(retries, 0)):
        delay = min(backoff_s * (2 ** attempt), max_backoff_s)
        out.append(delay * (1.0 + jitter * float(rng.uniform())))
    return out


def step_dir(directory: str, step: int) -> str:
    """The directory of step ``step``'s checkpoint."""
    return os.path.join(directory, f"step_{step:08d}")


def save(directory: str, step: int, tree: Mapping,
         metadata: Optional[Dict] = None, keep: int = 3, *,
         retries: int = 3, backoff_s: float = 0.01,
         max_backoff_s: float = 0.25, jitter: float = 0.5,
         backoff_seed: int = 0,
         io_check: Optional[Callable[[], None]] = None,
         on_retry: Optional[Callable[[int, BaseException], None]] = None,
         sleep: Callable[[float], None] = time.sleep) -> str:
    """Write one checkpoint of the nested dict ``tree`` (leaves: tensors
    or arrays) durably and atomically; returns its directory.

    ``io_check`` is called at the start of every write attempt and may
    raise ``OSError`` (fault injection). A failed attempt retries up to
    ``retries`` times after the delays of :func:`retry_delays` (slept
    through ``sleep``), each observed by ``on_retry(attempt, exc)``, then
    re-raises."""
    os.makedirs(directory, exist_ok=True)
    final = step_dir(directory, step)
    pool, flat, sums = _checksum_pool(), {}, {}
    for k, v in _flatten_with_paths(tree).items():
        flat[k] = to_numpy(v)
        sums[k] = pool.submit(_checksum, flat[k])
    pool.shutdown(wait=False)           # the queued checksums still run

    def manifest() -> Dict:
        return {"step": step, "arrays": sorted(flat),
                "checksums": {k: f.result() for k, f in sums.items()},
                **(metadata or {})}

    delays = retry_delays(retries, backoff_s, max_backoff_s=max_backoff_s,
                          jitter=jitter, seed=backoff_seed)
    attempt = 0
    while True:
        tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
        try:
            _write_attempt(tmp, flat, manifest, io_check)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)              # atomic commit
            _fsync_path(directory)
            break
        except OSError as e:
            shutil.rmtree(tmp, ignore_errors=True)
            if attempt >= len(delays):
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(delays[attempt])
            attempt += 1
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(os.path.basename(final))
        f.flush()
        os.fsync(f.fileno())
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    _fsync_path(directory)
    _cleanup(directory, keep)
    return final


def _cleanup(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
    # sweep tmp dirs abandoned by writers killed mid-save
    for d in os.listdir(directory):
        if d.startswith(".tmp_ckpt_"):
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def available_steps(directory: str) -> List[int]:
    """Steps of every complete-looking checkpoint dir, ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for d in sorted(os.listdir(directory)):
        if d.startswith("step_") and os.path.exists(
                os.path.join(directory, d, "manifest.json")):
            try:
                out.append(int(d.split("_")[1]))
            except ValueError:
                continue
    return out


def latest_step(directory: str) -> Optional[int]:
    """Newest checkpoint step: ``LATEST`` when it points at a directory,
    else a scan of the ``step_*`` dirs."""
    latest = os.path.join(directory, "LATEST")
    if os.path.exists(latest):
        with open(latest) as f:
            name = f.read().strip()
        if os.path.isdir(os.path.join(directory, name)):
            try:
                return int(name.split("_")[1])
            except (IndexError, ValueError):
                pass
    steps = available_steps(directory)
    return steps[-1] if steps else None


def _load_verified(directory: str, step: int
                   ) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Load and checksum-verify one checkpoint; raises CheckpointCorruption
    on any integrity failure."""
    path = os.path.join(directory, f"step_{step:08d}")
    with _checksum_pool() as pool:
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            flat, sums = _read_npz(os.path.join(path, "arrays.npz"),
                                   manifest.get("checksums", {}), pool)
        except (OSError, ValueError, json.JSONDecodeError,
                zipfile.BadZipFile, zlib.error, EOFError) as e:
            raise CheckpointCorruption(f"step {step}: {e}") from e
        sums = {k: f.result() for k, f in sums.items()}
    missing = [k for k in manifest.get("arrays", []) if k not in flat]
    if missing:
        raise CheckpointCorruption(f"step {step}: arrays {missing} listed in "
                                   f"manifest but absent from arrays.npz")
    for k, want in manifest.get("checksums", {}).items():
        if k not in flat:
            raise CheckpointCorruption(f"step {step}: checksummed array "
                                       f"{k!r} missing")
        got = sums[k]
        if got != want:
            raise CheckpointCorruption(
                f"step {step}: checksum mismatch for {k!r} "
                f"({got} != manifest {want})")
    return flat, manifest


def verify(directory: str, step: int) -> bool:
    """True iff the checkpoint at ``step`` passes integrity verification."""
    try:
        _load_verified(directory, step)
        return True
    except CheckpointCorruption:
        return False


def find_good_step(directory: str, step: Optional[int] = None
                   ) -> Optional[int]:
    """The newest verified-good step <= ``step`` (or <= latest); None when
    no checkpoint verifies."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    for s in reversed([s for s in available_steps(directory) if s <= step]):
        if verify(directory, s):
            return s
    return None


def read_manifest(directory: str, step: Optional[int] = None) -> Dict:
    """The checkpoint's manifest alone (no array load)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def restore(directory: str, template: Mapping, step: Optional[int] = None,
            *, fallback: bool = True) -> Tuple[Dict, Dict]:
    """Returns (tree, manifest): ``tree`` mirrors ``template`` (a nested
    dict whose leaves have ``.shape`` and a torch ``.dtype``) with CPU
    tensors of the template's dtypes. Every candidate checkpoint is
    checksum-verified; on corruption the restore walks back to the last
    verified-good step (``fallback=False`` pins the requested step).
    Template mismatches always raise."""
    start = step if step is not None else latest_step(directory)
    if start is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    candidates = ([start] if not fallback else
                  list(reversed([s for s in available_steps(directory)
                                 if s <= start])) or [start])
    errors = []
    for s in candidates:
        try:
            flat, manifest = _load_verified(directory, s)
        except CheckpointCorruption as e:
            errors.append(str(e))
            continue
        return _unflatten_like(template, flat), manifest
    raise CheckpointCorruption(
        f"no verified-good checkpoint under {directory} "
        f"(tried steps {candidates}): " + "; ".join(errors))
