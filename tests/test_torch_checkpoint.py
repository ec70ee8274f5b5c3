"""The port's checkpoint store (``checkpoint/store.py``) and its path-named
flattening (``common/tree.py``) against the JAX package's
(``tests/test_checkpoint.py`` mirrored): atomicity, round trip, bf16,
elastic reshard, keep-last-N, the crash windows, and checkpoints written
by either package read by the other. Leaf values are compared exactly.
"""

import json
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.common.tree import tree_flatten_with_paths as jax_flatten
from repro.core.resume import ResumableRunner as JaxRunner
from repro.malgen import MalGenConfig as JaxConfig
from repro.malgen import make_seed_streaming as jax_seed_streaming
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    load_checkpoint,
    save_checkpoint,
    sweep_stale_tmp,
)
from repro_torch.common.tree import tree_flatten_with_paths, tree_unflatten
from repro_torch.core.resume import ResumableRunner
from repro_torch.core.streaming import carry_zeros_host
from repro_torch.malgen import MalGenConfig, make_seed_streaming

KW = dict(num_sites=301, num_entities=1000, marked_site_fraction=0.2,
          marked_event_fraction=0.3)
# the resumable state's leaf names in the JAX package (jax 0.9.0)
STATE_NAMES = {
    "streams": ["carry", "chunks_done", "fingerprint"],
    "sphere": ["carry", "chunks_done", "fingerprint"],
    "mapreduce_combiner": ["carry", "chunks_done", "fingerprint"],
    "mapreduce": ["carry/0", "carry/1/sent", "carry/1/overflow",
                  "carry/1/capacity", "carry/1/rounds", "carry/1/residual",
                  "carry/1/bytes_exchanged", "chunks_done", "fingerprint"],
}


def make_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {
            "w": torch.randn(64, 32, generator=g),
            "emb": torch.randn(128, 16, generator=g).to(torch.bfloat16),
        },
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _bits(x):
    """A leaf as comparable numpy (bf16 by its 16 bits)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    if x.dtype == jnp.bfloat16:
        return np.asarray(x).view(np.int16)
    return np.asarray(x)


def assert_state_equal(a, b):
    fa, fb = tree_flatten_with_paths(a), tree_flatten_with_paths(b)
    assert [n for n, _ in fa] == [n for n, _ in fb]
    for (name, x), (_, y) in zip(fa, fb):
        assert _dtype(x) == _dtype(y), name
        np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=name)


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


# ------------------------------------------------------------------ tree
class Pair(NamedTuple):
    left: object
    right: object


def test_flatten_names_and_order_equal_jax():
    """Dict keys sorted, tuple and list items by index, NamedTuple fields
    by name, None an empty subtree: JAX's names in JAX's order."""
    def tree(leaf):
        return {"z": leaf(1), "a": (leaf(2), [leaf(3), None, leaf(4)]),
                "m": Pair(left=leaf(5), right={"y": leaf(6), "b": leaf(7)}),
                "n": None}

    got = tree_flatten_with_paths(tree(lambda v: torch.tensor(v)))
    want = jax_flatten(tree(lambda v: jnp.int32(v)))
    assert [n for n, _ in got] == [n for n, _ in want]
    assert [int(x) for _, x in got] == [int(x) for _, x in want]
    like = tree(lambda v: torch.tensor(v))
    back = tree_unflatten(like, [x * 10 for _, x in got])
    assert list(back) == list(like)
    assert isinstance(back["m"], Pair) and back["n"] is None
    assert int(back["m"].right["b"]) == 70 and int(back["a"][1][2]) == 40
    with pytest.raises(ValueError, match="fewer leaves"):
        tree_unflatten(like, [1, 2])
    with pytest.raises(ValueError, match="more leaves"):
        tree_unflatten(like, list(range(8)))


@pytest.mark.parametrize("backend", list(STATE_NAMES))
def test_resumable_state_names_equal_jax(backend):
    """The checkpointed dict of both runners at P = 1: the same names,
    shapes and dtypes (every leaf int32)."""
    cfg = MalGenConfig(**KW)
    seed = make_seed_streaming(7, cfg, 8, 64, device="cpu")
    runner = ResumableRunner(seed, cfg, nodes=1, num_chunks=8,
                             chunk_records=64, segment_chunks=1,
                             backend=backend, device="cpu")
    got = tree_flatten_with_paths(
        runner._pack_state(runner._zero_state()))
    jcfg = JaxConfig(**KW)
    jrunner = JaxRunner(
        jax_seed_streaming(jax.random.key(7), jcfg, 8, 64), jcfg,
        mesh=jax.make_mesh((1,), ("data",)), num_chunks=8,
        chunk_records=64, segment_chunks=1, backend=backend)
    want = jax_flatten(jrunner._pack_state(jrunner._zero_state()))
    assert [n for n, _ in got] == [n for n, _ in want] \
        == STATE_NAMES[backend]
    for (name, x), (_, y) in zip(got, want):
        assert np.asarray(x).dtype == np.asarray(y).dtype == np.int32, name
        assert np.shape(x) == np.shape(y), name


# ----------------------------------------------------------------- store
def test_roundtrip(tmp_path):
    state = make_state()
    state["host"] = np.arange(5, dtype=np.int64)
    state["cursor"] = np.int32(3)
    save_checkpoint(tmp_path, 42, state)
    assert latest_step(tmp_path) == 42
    got = load_checkpoint(tmp_path, 42, state)
    for name, leaf in tree_flatten_with_paths(got):
        assert isinstance(leaf, torch.Tensor), name
        assert leaf.device.type == "cpu", name
    assert got["cursor"].shape == () and int(got["cursor"]) == 3
    assert got["host"].dtype == torch.int64
    assert_state_equal({k: state[k] for k in ("params", "step")},
                       {k: got[k] for k in ("params", "step")})


def test_bf16_preserved(tmp_path):
    state = make_state()
    save_checkpoint(tmp_path, 1, state)
    manifest = json.loads(
        (tmp_path / "step_00000001" / "manifest.json").read_text())
    dtypes = {e["name"]: e["dtype"] for e in manifest["leaves"]}
    assert dtypes == {"params/emb": "bfloat16", "params/w": "float32",
                      "step": "int32"}
    with np.load(tmp_path / "step_00000001" / "shard_000.npz") as z:
        assert z["params/emb"].dtype == np.uint16
    got = load_checkpoint(tmp_path, 1, state)
    assert got["params"]["emb"].dtype == torch.bfloat16
    assert_state_equal(state, got)


@pytest.mark.parametrize("write_shards,read_like", [(1, 4), (4, 1), (8, 3)])
def test_elastic_reshard(tmp_path, write_shards, read_like):
    """Written by N writers, restored whatever the reader's topology."""
    state = make_state()
    save_checkpoint(tmp_path, 5, state, num_shards=write_shards)
    got = load_checkpoint(tmp_path, 5, state)
    assert_state_equal(state, got)
    mgr = CheckpointManager(tmp_path, num_shards=read_like)
    step, got2 = mgr.restore_latest(state)
    assert step == 5
    assert_state_equal(state, got2)


def test_uncommitted_step_invisible(tmp_path):
    state = make_state()
    save_checkpoint(tmp_path, 1, state)
    save_checkpoint(tmp_path, 2, state)
    (tmp_path / "step_00000002.COMMITTED").unlink()
    assert latest_step(tmp_path) == 1


def test_manager_keeps_last_n(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    state = make_state()
    for s in range(5):
        mgr.save(s, state)
    steps = sorted(int(p.stem.split("_")[1])
                   for p in tmp_path.glob("step_*.COMMITTED"))
    assert steps == [3, 4]
    step, got = mgr.restore_latest(state)
    assert step == 4
    assert_state_equal(state, got)


def test_restore_latest_empty(tmp_path):
    mgr = CheckpointManager(tmp_path / "none")
    assert mgr.restore_latest(make_state()) == (None, None)


def test_shape_mismatch_raises(tmp_path):
    state = make_state()
    save_checkpoint(tmp_path, 1, state)
    wrong = {**state, "params": {**state["params"],
                                 "w": torch.zeros(2, 2)}}
    with pytest.raises(AssertionError, match="ckpt"):
        load_checkpoint(tmp_path, 1, wrong)


def test_missing_only_shard_raises_file_not_found(tmp_path):
    state = make_state()
    save_checkpoint(tmp_path, 3, state)
    (tmp_path / "step_00000003" / "shard_000.npz").unlink()
    with pytest.raises(FileNotFoundError, match="missing"):
        load_checkpoint(tmp_path, 3, state)


def test_missing_one_of_n_shards_never_restores_silently(tmp_path):
    """Losing one shard of four leaves a short concatenation, which the
    shape check refuses."""
    state = make_state()
    save_checkpoint(tmp_path, 3, state, num_shards=4)
    (tmp_path / "step_00000003" / "shard_002.npz").unlink()
    with pytest.raises(AssertionError, match="ckpt"):
        load_checkpoint(tmp_path, 3, state)


def test_pre_commit_hook_crash_leaves_step_uncommitted(tmp_path):
    state = make_state()
    save_checkpoint(tmp_path, 1, state)

    class Boom(Exception):
        pass

    seen = []

    def hook(tmp_dir):
        # the crash window: every shard and the manifest written, no commit
        seen.append((tmp_dir / "manifest.json").exists()
                    and (tmp_dir / "shard_000.npz").exists())
        raise Boom()

    with pytest.raises(Boom):
        save_checkpoint(tmp_path, 2, state, pre_commit_hook=hook)
    assert seen == [True]
    assert latest_step(tmp_path) == 1
    names = [p.name for p in tmp_path.iterdir()]
    assert any(n.startswith(".tmp_step_2_") for n in names), names
    assert "step_00000002.COMMITTED" not in names


def test_manager_init_sweeps_stale_tmp_dirs(tmp_path):
    state = make_state()

    def killed(tmp_dir):
        raise RuntimeError("killed")

    with pytest.raises(RuntimeError):
        save_checkpoint(tmp_path, 2, state, pre_commit_hook=killed)
    assert any(p.name.startswith(".tmp_step_") for p in tmp_path.iterdir())
    mgr = CheckpointManager(tmp_path)
    assert not any(p.name.startswith(".tmp_") for p in tmp_path.iterdir())
    mgr.save(3, state)
    assert latest_step(tmp_path) == 3


def test_sweep_stale_tmp_returns_removed_and_handles_missing_dir(tmp_path):
    assert sweep_stale_tmp(tmp_path / "never_created") == []
    (tmp_path / ".tmp_step_7_abc").mkdir()
    (tmp_path / "step_00000001").mkdir()
    removed = sweep_stale_tmp(tmp_path)
    assert [p.name for p in removed] == [".tmp_step_7_abc"]
    assert (tmp_path / "step_00000001").exists()


def test_gc_under_out_of_order_interleaved_saves(tmp_path):
    """Keep-last-N keeps the N largest steps, whatever order they were
    saved in."""
    mgr = CheckpointManager(tmp_path, keep=2)
    state = make_state()
    for s in (5, 1, 9, 3, 7):
        mgr.save(s, state)
    steps = sorted(int(p.stem.split("_")[1])
                   for p in tmp_path.glob("step_*.COMMITTED"))
    assert steps == [7, 9]
    dirs = sorted(int(p.name.split("_")[1])
                  for p in tmp_path.glob("step_*") if p.is_dir())
    assert dirs == [7, 9]
    got_step, got = mgr.restore_latest(state)
    assert got_step == 9
    assert_state_equal(state, got)


def test_streaming_carry_elastic_reshard(tmp_path):
    """The resumable state's mapreduce carry, written by 4 shards,
    restored at 1; the ShuffleStats come back a NamedTuple."""
    carry = carry_zeros_host("mapreduce", 4, 304, 52)
    owned, stats = carry
    owned.copy_(torch.arange(owned.numel(), dtype=torch.int32)
                .reshape(owned.shape) % 251)
    for i, f in enumerate(stats):
        f.copy_(torch.arange(4, dtype=torch.int32) + 10 * i)
    state = {"carry": carry, "chunks_done": np.int32(3)}
    save_checkpoint(tmp_path, 2, state, num_shards=4)
    like = {"carry": carry_zeros_host("mapreduce", 4, 304, 52),
            "chunks_done": np.zeros((), np.int32)}
    got = load_checkpoint(tmp_path, 2, like)
    assert type(got["carry"][1]) is type(stats)
    assert_state_equal(state, got)


# ------------------------------------------------------ across packages
def _jax_state():
    k = jax.random.key(3)
    return {"carry": (jnp.arange(4 * 6, dtype=jnp.int32).reshape(4, 6),
                      {"sent": jnp.arange(4, dtype=jnp.int32)}),
            "emb": jax.random.normal(k, (8, 3), jnp.bfloat16),
            "w": jax.random.normal(k, (5, 2), jnp.float32),
            "chunks_done": np.int32(2)}


def _to_torch(x):
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("num_shards", (1, 4))
@pytest.mark.parametrize("writer", ("jax", "port"))
def test_checkpoints_cross_the_packages(tmp_path, writer, num_shards):
    """A step written by one package (any shard count) loads in the
    other with the same names, dtypes and bits."""
    jstate = _jax_state()
    tstate = tree_unflatten(jstate, [_to_torch(x)
                                     for _, x in jax_flatten(jstate)])
    if writer == "jax":
        jax_save(tmp_path, 4, jstate, num_shards=num_shards)
        got = load_checkpoint(tmp_path, 4, tstate)
        assert_state_equal(got, tstate)
        assert got["emb"].dtype == torch.bfloat16
    else:
        save_checkpoint(tmp_path, 4, tstate, num_shards=num_shards)
        got = jax_load(tmp_path, 4, jstate)
        assert got["emb"].dtype == jnp.bfloat16
        for (name, x), (_, y) in zip(jax_flatten(got), jax_flatten(jstate)):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=name)
    assert latest_step(tmp_path) == 4
