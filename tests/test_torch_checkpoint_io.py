"""The port's checkpoint files (``repro_torch.train.checkpoint``): the
checksums run on threads beside the writes and reads, and a stored member
the manifest checksums is read in one piece from its offset; neither may
change what is written or restored.

* Mixed leaves (f32, bf16 as ``|V2``, int64, empty, 0-d) restore equal,
  and the manifest equals the reference's checksums on the same arrays.
* A checkpoint written by the JAX reference restores in the port, and
  one written by the port restores in the reference, leaf for leaf.
* Members the one-piece read does not take (deflated, or in Fortran
  order) restore equal through ``np.load``'s reader.
* A truncated ``arrays.npz``, a flipped data byte and a broken local
  header fail verification, and the restore walks back to the last good
  step.
"""
import json
import os
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.train import checkpoint as jckpt

from repro_torch.train import checkpoint as ckpt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per worker of the parallel tier-1 run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tree(seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(300, 37, generator=gen),
                       "b": torch.randn(5, 7, generator=gen).bfloat16()},
            "opt": {"count": torch.arange(10, dtype=torch.int64),
                    "empty": torch.zeros(0, 4),
                    "scale": torch.tensor(3.5)}}


def _same(back, tree) -> bool:
    return all(_same(back[k], v) if isinstance(v, dict)
               else torch.equal(back[k].reshape(v.shape), v)
               for k, v in tree.items())


def _npz(tmp_path, step):
    return os.path.join(ckpt.step_dir(str(tmp_path), step), "arrays.npz")


def test_round_trip_and_manifest(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 1, tree, {"note": "x"})
    back, manifest = ckpt.restore(str(tmp_path), tree)
    assert _same(back, tree)
    assert back["params"]["b"].dtype == torch.bfloat16
    with np.load(_npz(tmp_path, 1)) as z:
        want = {k: jckpt._checksum(z[k]) for k in z.files}
    assert manifest["checksums"] == want
    assert manifest["note"] == "x" and manifest["step"] == 1


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_restores_across_packages(tmp_path, writer):
    tree = _tree(1)
    flat = {k: ckpt.to_numpy(v) for k, v in
            ckpt._flatten_with_paths(tree).items()}
    np_tree = {"params": {"w": flat["params/w"], "b": flat["params/b"]},
               "opt": {"count": flat["opt/count"], "empty": flat["opt/empty"],
                       "scale": flat["opt/scale"]}}
    if writer == "reference":
        jckpt.save(str(tmp_path), 2, np_tree)
        back, manifest = ckpt.restore(str(tmp_path), tree)
        assert _same(back, tree)
    else:
        ckpt.save(str(tmp_path), 2, tree)
        back, manifest = jckpt.restore(str(tmp_path), np_tree)
        for k, v in ckpt._flatten_with_paths(back).items():
            assert np.asarray(v).tobytes() == flat[k].tobytes(), k
    assert manifest["step"] == 2


@pytest.mark.parametrize("kind", ["deflated", "fortran"])
def test_members_through_np_load(tmp_path, kind):
    tree = _tree(2)
    ckpt.save(str(tmp_path), 3, tree)
    path = _npz(tmp_path, 3)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    if kind == "deflated":
        np.savez_compressed(path, **arrays)
        with zipfile.ZipFile(path) as zf:
            assert {i.compress_type for i in zf.infolist()} == {
                zipfile.ZIP_DEFLATED}
    else:
        arrays["params/w"] = np.asfortranarray(arrays["params/w"])
        np.savez(path, **arrays)
    back, _ = ckpt.restore(str(tmp_path), tree)
    assert _same(back, tree)


def _truncate(path):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


def _flip_data_byte(path):
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo("params/w.npy")
    with open(path, "r+b") as f:
        f.seek(info.header_offset + 30 + len(info.filename)
               + len(info.extra) + 128 + 1000)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0x40]))


def _break_local_header(path):
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo("params/w.npy")
    with open(path, "r+b") as f:
        f.seek(info.header_offset)
        f.write(b"XXXX")


@pytest.mark.parametrize("damage", [_truncate, _flip_data_byte,
                                    _break_local_header])
def test_damage_walks_back(tmp_path, damage):
    tree, later = _tree(3), _tree(4)
    ckpt.save(str(tmp_path), 4, tree)
    ckpt.save(str(tmp_path), 5, later)
    damage(_npz(tmp_path, 5))
    assert not ckpt.verify(str(tmp_path), 5)
    with pytest.raises(ckpt.CheckpointCorruption):
        ckpt.restore(str(tmp_path), tree, 5, fallback=False)
    back, manifest = ckpt.restore(str(tmp_path), tree)
    assert manifest["step"] == 4 and _same(back, tree)
    with open(os.path.join(ckpt.step_dir(str(tmp_path), 5),
                           "manifest.json")) as f:
        assert "params/w" in json.load(f)["checksums"]
