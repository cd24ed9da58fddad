"""The port's checkpointer against the JAX package's, and its msgpack codec
against the ``msgpack`` package.

- The layout is shared: the port restores a checkpoint the reference wrote
  and the reference restores the port's, bf16 leaves included, bitwise;
  a train state converted by ``convert.train_state_from_numpy`` round trips.
- ``checkpoint.codec`` packs byte for byte as ``msgpack.packb`` and reads
  what it writes.
- The reference's own checkpoint tests, on the port: round trip, async save
  then wait, keep-k, no partial checkpoint visible, crc corruption, restore
  the latest of many; plus ``device=``, and ``shardings=`` that names no
  leaf (each leaf then restores as a plain tensor, as the reference's).
"""

import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.usefixtures("one_torch_thread")

from _torch_parity import one_torch_thread  # noqa: E402,F401

from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro_torch.checkpoint import Checkpointer, codec  # noqa: E402
from repro_torch.convert import train_state_from_numpy, train_state_to_numpy  # noqa: E402


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(8, 8, generator=g),
                   "b": torch.randn(8, generator=g).to(torch.bfloat16),
                   "f8": torch.randn(4, generator=g).to(torch.float8_e4m3fn)},
        "opt": {"step": torch.tensor(7, dtype=torch.int32)},
    }


def _jtree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": jnp.asarray(rng.normal(size=(8, 8)), jnp.float32),
                   "b": jnp.asarray(rng.normal(size=(8,)), jnp.bfloat16)},
        "opt": {"step": jnp.asarray(7, jnp.int32)},
    }


def _bits(t):
    return t.view(torch.uint8) if t.dtype.itemsize == 1 else t.view(torch.int16) \
        if t.dtype.itemsize == 2 else t


def test_port_restores_the_reference_checkpoint_bitwise(tmp_path):
    ref = _jtree(3)
    JCheckpointer(str(tmp_path)).save(5, ref, blocking=True)
    template = {"params": {"w": torch.zeros(8, 8), "b": torch.zeros(8, dtype=torch.bfloat16)},
                "opt": {"step": torch.tensor(0, dtype=torch.int32)}}
    out = Checkpointer(str(tmp_path)).restore(template)
    assert out["params"]["b"].dtype == torch.bfloat16 and out["opt"]["step"].dtype == torch.int32
    np.testing.assert_array_equal(out["params"]["w"].numpy(), np.asarray(ref["params"]["w"]))
    np.testing.assert_array_equal(out["params"]["b"].view(torch.int16).numpy(),
                                  np.asarray(ref["params"]["b"]).view(np.int16))
    assert int(out["opt"]["step"]) == 7


def test_reference_restores_the_port_checkpoint_bitwise(tmp_path):
    tree = _tree(4)
    del tree["params"]["f8"]
    Checkpointer(str(tmp_path)).save(6, tree, blocking=True)
    out = JCheckpointer(str(tmp_path)).restore(_jtree())
    assert out["params"]["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(out["params"]["w"]), tree["params"]["w"].numpy())
    np.testing.assert_array_equal(np.asarray(out["params"]["b"]).view(np.int16),
                                  tree["params"]["b"].view(torch.int16).numpy())
    assert int(out["opt"]["step"]) == 7


def test_train_state_round_trip_through_both_checkpointers(tmp_path):
    rng = np.random.default_rng(0)
    p = {"blocks": {"w": rng.normal(size=(2, 3, 4)).astype(np.float32)}}
    jstate = {"params": p, "opt": {"step": np.int32(11), "mu": jax.tree.map(np.abs, p),
                                   "nu": jax.tree.map(np.square, p)}}
    state = train_state_from_numpy(jstate, "cpu")
    assert state["opt"]["step"].dtype == torch.int32
    Checkpointer(str(tmp_path / "a")).save(11, state, blocking=True)
    back = JCheckpointer(str(tmp_path / "a")).restore(jax.tree.map(jnp.asarray, jstate))
    JCheckpointer(str(tmp_path / "b")).save(11, back, blocking=True)
    again = Checkpointer(str(tmp_path / "b")).restore(state)
    jax.tree.map(np.testing.assert_array_equal, train_state_to_numpy(again),
                 jax.tree.map(np.asarray, jstate))


@pytest.mark.parametrize("value", [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63, 0.5, -1e300,
    "", "a" * 31, "a" * 32, "é" * 200, "x" * 70000, b"", b"\x00" * 300, [], list(range(15)),
    list(range(16)), list(range(70000)), {}, {str(i): i for i in range(15)},
    {str(i): [i, {"k": None}] for i in range(16)}, (1, "two"),
    {"step": 4, "keys": ["params/w"], "dtypes": {"params/w": "bfloat16"},
     "crc32": {"params/w": 4294967295}, "nprocs": 1},
], ids=lambda v: type(v).__name__ + str(len(v) if hasattr(v, "__len__") else v)[:12])
def test_codec_matches_msgpack_byte_for_byte(value):
    packed = codec.packb(value)
    assert packed == msgpack.packb(value)
    assert codec.unpackb(packed) == msgpack.unpackb(packed)


def test_codec_rejects_what_it_cannot_hold():
    with pytest.raises(TypeError):
        codec.packb({1.5j: 0})
    with pytest.raises(OverflowError):
        codec.packb(2 ** 64)
    with pytest.raises(ValueError, match="truncated"):
        codec.unpackb(codec.packb("abc")[:-1])
    with pytest.raises(ValueError, match="subset"):
        codec.unpackb(b"\xd4\x01\x00")  # fixext 1


def test_roundtrip_keeps_dtypes_bitwise(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    tree = _tree()
    ckpt.save(7, tree, blocking=True)
    out = ckpt.restore(tree)
    for k in ("w", "b", "f8"):
        assert out["params"][k].dtype == tree["params"][k].dtype
        assert torch.equal(_bits(out["params"][k]), _bits(tree["params"][k]))
    assert int(out["opt"]["step"]) == 7


def test_save_copies_before_the_caller_moves_on(tmp_path):
    """Training overwrites its tensors in place right after ``save``: the
    checkpoint must hold the values at the call."""
    ckpt = Checkpointer(str(tmp_path))
    tree = _tree()
    want = tree["params"]["w"].clone()
    ckpt.save(1, tree)
    tree["params"]["w"].add_(1.0)
    ckpt.wait()
    assert torch.equal(ckpt.restore(tree)["params"]["w"], want)


def test_async_save_then_wait(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    ckpt.save(1, _tree())
    ckpt.wait()
    assert ckpt.latest_step() == 1


def test_keep_k_garbage_collection(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ckpt.save(s, _tree(s), blocking=True)
    assert ckpt.all_steps() == [3, 4]


def test_no_partial_checkpoints_visible(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=3)
    ckpt.save(5, _tree(), blocking=True)
    assert not any(n.endswith(".tmp") for n in os.listdir(str(tmp_path)))
    assert sorted(os.listdir(tmp_path / "step_00000005")) == ["META", "proc_00000.npz"]


def test_crc_corruption_detected(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    tree = _tree()
    ckpt.save(3, tree, blocking=True)
    path = os.path.join(str(tmp_path), "step_00000003", "proc_00000.npz")
    data = np.load(path)
    arrs = {k: data[k].copy() for k in data.files}
    key = [k for k in arrs if k.endswith("w")][0]
    arrs[key][0, 0] += 1.0
    np.savez(path, **arrs)
    with pytest.raises(IOError, match="corruption"):
        ckpt.restore(tree)


def test_restore_latest_of_many_onto_a_device(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=5)
    for s in (10, 20, 30):
        ckpt.save(s, _tree(s), blocking=True)
    out = ckpt.restore(_tree(), device="cpu")
    assert torch.equal(out["params"]["w"], _tree(30)["params"]["w"])
    assert ckpt.restore(_tree(), step=10)["opt"]["step"].device.type == "cpu"
    out = ckpt.restore(_tree(), shardings={})
    assert type(out["params"]["w"]) is torch.Tensor
    assert torch.equal(out["params"]["w"], _tree(30)["params"]["w"])
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(_tree())
