"""The port's checkpoint manager (``repro_torch.checkpoint``) against the
JAX package's ``repro.checkpoint``, on the CPU.

* **The cases of ``tests/test_checkpoint.py``** on the port: round trip
  (structure-preserving onto a device, and the structure-free
  ``restore_arrays``), digest verification with the typed
  ``CheckpointError`` (bitflip, torn write, unreadable manifest, a
  missing key), ``latest_step()`` falling back past a corrupted newest
  step, keep-N GC, the crash-orphan ``step_N.tmp.*`` sweep, a failed
  save leaving nothing, and the manifest's records.
* **One on-disk format.** The same tree saved by both packages gives the
  same file names, digests and bytes; a directory written by either
  restores in the other byte for byte (values, dtypes, shapes, extra).
* **A device mesh** (a (1, 1) gloo mesh of this one process, closed in a
  ``finally``): ``restore(shardings=)`` places each leaf on its
  sharding, the counterpart of ``tests/test_distributed.py``'s
  ``test_elastic_reshard_restore``, and a save of DTensor leaves is byte
  for byte a save of the plain tensors.
"""
import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro_torch.checkpoint import CheckpointError, CheckpointManager


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "coords": rng.normal(size=(2, 8, 3)).astype(np.float32),
        "veloc": rng.normal(size=(2, 8, 3)).astype(np.float32),
        "nl": {"senders": rng.integers(0, 16, 64).astype(np.int32),
               "mask": rng.integers(0, 2, 64).astype(bool),
               "overflow": np.asarray(False)},
        "step": np.int64(7),
    }


def _torch_tree(seed=0):
    """The same tree as tensors (numpy scalars stay numpy)."""
    t = _tree(seed)
    return {"coords": torch.from_numpy(t["coords"]),
            "veloc": torch.from_numpy(t["veloc"]),
            "nl": {k: torch.from_numpy(np.array(v))
                   for k, v in t["nl"].items()},
            "step": t["step"]}


def _flip_byte(path, offset=16):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def _array_files(cm, step):
    return sorted(glob.glob(os.path.join(cm.dir, f"step_{step}", "*.npy")))


def _files(d):
    return {os.path.basename(p): open(p, "rb").read()
            for p in sorted(glob.glob(os.path.join(d, "*.npy")))}


class TestRoundTrip:
    def test_save_restore_tree(self, tmp_path):
        cm = CheckpointManager(str(tmp_path), keep=3)
        tree = _tree()
        cm.save(1, tree, extra={"chunks_done": 1, "mode": "w8a8"})
        out = cm.restore(1, like=tree, device="cpu")
        for key in ("coords", "veloc"):
            assert isinstance(out[key], torch.Tensor)
            np.testing.assert_array_equal(out[key].numpy(), tree[key])
        np.testing.assert_array_equal(out["nl"]["senders"].numpy(),
                                      tree["nl"]["senders"])
        assert int(out["step"]) == 7
        assert cm.extra(1) == {"chunks_done": 1, "mode": "w8a8"}

    def test_restore_arrays_structure_free(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        cm.save(2, _torch_tree(1))          # tensors go to the host
        arrays = cm.restore_arrays(2)
        assert set(arrays) == {"coords", "veloc", "nl/senders", "nl/mask",
                               "nl/overflow", "step"}
        np.testing.assert_array_equal(arrays["coords"], _tree(1)["coords"])
        assert arrays["nl/mask"].dtype == bool

    def test_missing_step_raises_typed(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        with pytest.raises(CheckpointError, match="no checkpoint"):
            cm.restore(5, like=_tree(), device="cpu")
        with pytest.raises(CheckpointError):
            cm.restore_arrays(5)

    def test_missing_key_raises_typed(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        cm.save(1, _tree())
        with pytest.raises(CheckpointError, match="missing from the"):
            cm.restore(1, like={"coords": np.zeros(1), "nope": np.zeros(1)},
                       device="cpu")


class TestCorruptionRejection:
    def test_bitflip_rejected_at_restore(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        tree = _tree()
        cm.save(1, tree)
        _flip_byte(_array_files(cm, 1)[0])
        assert not cm.is_valid(1)
        with pytest.raises(CheckpointError, match="SHA-256"):
            cm.restore(1, like=tree, device="cpu")
        with pytest.raises(CheckpointError, match="SHA-256"):
            cm.restore_arrays(1)

    def test_torn_write_rejected(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        tree = _tree()
        cm.save(1, tree)
        f = _array_files(cm, 1)[-1]
        with open(f, "r+b") as fh:
            fh.truncate(os.path.getsize(f) // 2)
        with pytest.raises(CheckpointError):
            cm.restore(1, like=tree, device="cpu")

    def test_unreadable_manifest_rejected(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        cm.save(1, _tree())
        with open(os.path.join(cm.dir, "step_1", "manifest.json"), "w") as f:
            f.write("{not json")
        assert not cm.is_valid(1)
        with pytest.raises(CheckpointError, match="manifest"):
            cm.restore(1, like=_tree(), device="cpu")

    def test_latest_step_skips_corrupted_newest(self, tmp_path):
        cm = CheckpointManager(str(tmp_path), keep=5)
        tree = _tree()
        for s in (1, 2, 3):
            cm.save(s, tree)
        _flip_byte(_array_files(cm, 3)[0])
        assert cm.all_steps() == [1, 2, 3]
        assert cm.latest_step() == 2
        out = cm.restore(cm.latest_step(), like=tree, device="cpu")
        np.testing.assert_array_equal(out["coords"].numpy(), tree["coords"])


class TestGC:
    def test_keep_n(self, tmp_path):
        cm = CheckpointManager(str(tmp_path), keep=2)
        for s in range(1, 6):
            cm.save(s, _tree(s))
        assert cm.all_steps() == [4, 5]

    def test_orphan_tmp_swept_and_ignored(self, tmp_path):
        cm = CheckpointManager(str(tmp_path), keep=2)
        cm.save(1, _tree())
        orphan = os.path.join(cm.dir, "step_7.tmp.deadbeef")
        os.makedirs(orphan)
        with open(os.path.join(orphan, "junk.npy"), "wb") as f:
            f.write(b"partial")
        assert cm.all_steps() == [1]        # tmp never listed
        assert cm.latest_step() == 1
        cm.save(2, _tree())
        assert not os.path.exists(orphan)   # swept by _gc
        assert cm.all_steps() == [1, 2]

    def test_failed_save_leaves_no_tmp(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))

        class Boom:
            def __array__(self, *args, **kw):
                raise RuntimeError("device fell over")

        with pytest.raises(RuntimeError, match="fell over"):
            cm.save(1, {"bad": Boom()})
        assert [n for n in os.listdir(cm.dir) if "tmp" in n] == []
        assert cm.all_steps() == []

    def test_overwrite_same_step(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        cm.save(1, _tree(0))
        cm.save(1, _tree(9))
        out = cm.restore_arrays(1)
        np.testing.assert_array_equal(out["coords"], _tree(9)["coords"])

    def test_manifest_records_shapes_and_hashes(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        cm.save(3, _tree())
        with open(os.path.join(cm.dir, "step_3", "manifest.json")) as f:
            manifest = json.load(f)
        meta = manifest["arrays"]["coords"]
        assert meta["shape"] == [2, 8, 3] and meta["dtype"] == "float32"
        assert len(meta["sha256"]) == 64


class TestAcrossPackages:
    EXTRA = {"chunks_done": 3, "config": {"md": {"mode": "w4a8"}}}

    def test_one_on_disk_format(self, tmp_path):
        """The same tree saved by both packages: the same manifest (keys,
        files, digests, shapes, dtypes) and the same file bytes."""
        jcm = JCheckpointManager(str(tmp_path / "jax"))
        tcm = CheckpointManager(str(tmp_path / "port"))
        jcm.save(4, _tree(3), extra=self.EXTRA)
        tcm.save(4, _torch_tree(3), extra=self.EXTRA)
        docs = [json.load(open(os.path.join(d, "step_4", "manifest.json")))
                for d in (jcm.dir, tcm.dir)]
        assert docs[0] == docs[1]
        assert list(docs[0]["arrays"]) == list(docs[1]["arrays"])
        assert (_files(os.path.join(jcm.dir, "step_4"))
                == _files(os.path.join(tcm.dir, "step_4")))

    def test_jax_written_restores_in_the_port(self, tmp_path):
        jcm = JCheckpointManager(str(tmp_path))
        tree = _tree(5)
        jcm.save(2, {**tree, "dev": jnp.arange(6, dtype=jnp.int32)},
                 extra=self.EXTRA)
        cm = CheckpointManager(str(tmp_path))
        assert cm.latest_step() == 2 and cm.extra(2) == self.EXTRA
        arrays = cm.restore_arrays(2)
        want = jcm.restore_arrays(2)
        assert set(arrays) == set(want)
        for k in want:
            assert arrays[k].dtype == want[k].dtype
            assert arrays[k].tobytes() == want[k].tobytes()
        out = cm.restore(2, like={**tree, "dev": np.zeros(6, np.int32)},
                         device="cpu")
        np.testing.assert_array_equal(out["dev"].numpy(), np.arange(6))
        assert out["nl"]["mask"].dtype == torch.bool

    def test_port_written_restores_in_jax(self, tmp_path):
        cm = CheckpointManager(str(tmp_path))
        cm.save(6, _torch_tree(7), extra=self.EXTRA)
        jcm = JCheckpointManager(str(tmp_path))
        assert jcm.latest_step() == 6 and jcm.extra(6) == self.EXTRA
        want = _tree(7)
        out = jcm.restore(6, like=want)
        for key in ("coords", "veloc"):
            np.testing.assert_array_equal(np.asarray(out[key]), want[key])
        assert np.asarray(out["nl"]["senders"]).dtype == np.int32
        _flip_byte(_array_files(cm, 6)[0])      # verified on the JAX side
        assert jcm.latest_step() is None


@pytest.fixture
def local_mesh():
    from repro_torch.launch.mesh import make_local_mesh
    try:
        yield make_local_mesh("cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class TestMesh:
    def test_elastic_reshard_restore(self, tmp_path, local_mesh):
        """Restore onto explicit shardings (the rescale path): every leaf
        a DTensor with its sharding's placements and the saved values; a
        leaf whose sharding is None comes back a plain tensor."""
        from repro_torch.launch import sharding as shd
        cm = CheckpointManager(str(tmp_path), keep=1)
        tree = _torch_tree()
        del tree["step"]
        cm.save(5, tree)
        specs = {"coords": shd.P(None, "model", None), "veloc": shd.P(),
                 "nl": {"senders": shd.P("data"), "mask": shd.P(None),
                        "overflow": shd.P()}}
        sh = shd.to_shardings(specs, local_mesh)
        sh["nl"]["overflow"] = None
        placed = shd.NamedSharding(local_mesh, (Shard(0), Replicate()),
                                   shd.P("data"))
        sh["nl"]["senders"] = placed     # a placement given as it is
        out = cm.restore(5, tree, device="cpu", shardings=sh)
        assert isinstance(out["coords"], DTensor)
        # over a mesh dim of one device every spec entry is replicated
        for key in ("coords", "veloc"):
            assert out[key].placements == (Replicate(), Replicate())
        assert out["nl"]["senders"].placements == sh["nl"]["senders"] \
            .placements
        assert out["coords"].device_mesh is local_mesh
        assert not isinstance(out["nl"]["overflow"], DTensor)
        for key in ("coords", "veloc"):
            assert torch.equal(out[key].full_tensor(), tree[key])
        assert torch.equal(out["nl"]["senders"].full_tensor(),
                           tree["nl"]["senders"])

    def test_save_from_the_mesh_is_a_plain_save(self, tmp_path, local_mesh):
        from torch.distributed.tensor import distribute_tensor
        tree = _torch_tree()
        del tree["step"]
        placed = {"coords": distribute_tensor(tree["coords"], local_mesh,
                                              [Shard(0), Shard(2)]),
                  "veloc": distribute_tensor(tree["veloc"], local_mesh,
                                             [Replicate(), Replicate()]),
                  "nl": tree["nl"]}
        a = CheckpointManager(str(tmp_path / "plain")).save(1, tree)
        b = CheckpointManager(str(tmp_path / "mesh")).save(1, placed)
        assert _files(a) == _files(b)
        with open(os.path.join(a, "manifest.json")) as f, \
                open(os.path.join(b, "manifest.json")) as g:
            assert json.load(f) == json.load(g)
