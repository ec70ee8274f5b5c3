"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's, on the CPU.

- JAX's ``repro.launch.dryrun`` forces 512 host devices when imported, so
  its side runs once in a subprocess: this file run as a script (``python
  tests/test_torch_dryrun.py OUT.json``). For all ten archs x four shapes
  x both production meshes it builds the cell's arguments and shardings
  (``build_lowerable``, compiling nothing) and dumps the ``shard_shape``
  of every leaf by path name, the argument bytes a device (the shards'
  bytes summed), the skipped cells' reasons, and the two meshes. The
  port's equal JAX's exactly.
- The MalStone B10 cells: 468,750,000 bytes a node on 256 devices,
  234,375,000 on 512, as in JAX's committed ``results/dryrun``; the
  backends read no ``entity_id``, which is why a record is 12 bytes.
- FLOPs: the count on ``meta`` equals the count of the same step on real
  CPU tensors at smoke size, and the one-repetition count (and, for an
  attention-free model, the count taken at two short sequences) equals
  the direct one.
- ``main`` writes a cell's JSON.
"""

import json
import math
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def _jax_main(out_path: str) -> None:
    import functools

    from repro.launch import dryrun as D  # forces 512 host devices

    import jax
    import numpy as np

    from repro.common.tree import tree_flatten_with_paths
    from repro.configs import ALIASES, get_config
    from repro.launch.mesh import batch_axes, make_production_mesh
    from repro.models import steps as S
    from repro.models import transformer as T
    from repro.models.sharding import sharding_ctx
    from repro.optim import adamw_init

    # one abstract init a config, not one for every call build_lowerable
    # makes (the functions read only shapes and dtypes)
    @functools.lru_cache(maxsize=None)
    def specs(name):
        cfg = get_config(name)
        out = {}

        def mk():
            p, a = T.init_params(jax.random.key(0), cfg)
            out["axes"] = a
            return S.TrainState(p, adamw_init(p, D._opt_cfg(cfg)))

        return jax.eval_shape(mk), out["axes"]

    S.params_specs = lambda cfg, with_opt, opt_cfg=None: (
        specs(cfg.name)[0] if with_opt else specs(cfg.name)[0].params)
    S.params_axes = lambda cfg: specs(cfg.name)[1]
    inputs = functools.lru_cache(maxsize=None)(D.input_specs)
    D.input_specs = lambda cfg, shape: inputs(cfg, shape)

    result = {"meshes": {}, "cells": {}}
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        result["meshes"]["pod2" if mp else "pod1"] = {
            "shape": list(dict(mesh.shape).items()),
            "batch_axes": list(batch_axes(mesh))}
        for arch in ALIASES:
            cfg = get_config(arch)
            for shape in S.SHAPES:
                cell = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
                ok, reason = S.shape_applicable(cfg, shape)
                if not ok:
                    result["cells"][cell] = {"status": "skipped",
                                             "reason": reason}
                    continue
                with sharding_ctx(
                        mesh, param_overrides=tuple(cfg.sharding_rules),
                        act_overrides=tuple(cfg.act_sharding_rules)):
                    _, args, shardings = D.build_lowerable(cfg, shape, mesh)
                leaves = tree_flatten_with_paths(args)
                shard = jax.tree.leaves(shardings)
                assert len(leaves) == len(shard)
                shards, total = {}, 0
                for (path, leaf), sh in zip(leaves, shard):
                    dims = tuple(sh.shard_shape(leaf.shape))
                    shards[path] = list(dims)
                    total += math.prod(dims) * np.dtype(leaf.dtype).itemsize
                result["cells"][cell] = {"status": "ok", "shards": shards,
                                         "argument_bytes": total}
    pathlib.Path(out_path).write_text(json.dumps(result))


if __name__ == "__main__":
    _jax_main(sys.argv[1])
    sys.exit(0)

import dataclasses  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import ALIASES as JAX_ALIASES  # noqa: E402

from repro_torch.common import tree as tr  # noqa: E402
from repro_torch.common.types import EventLog  # noqa: E402
from repro_torch.configs import ALIASES, get_config, get_smoke_config  # noqa: E402
from repro_torch.core import run  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import batch_axes, make_production_mesh  # noqa: E402
from repro_torch.models import steps as S  # noqa: E402
from repro_torch.models.sharding import sharding_ctx  # noqa: E402
from repro_torch.models.steps import InputShape  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TIMEOUT = 240
B10 = {False: 468_750_000, True: 234_375_000}
FLOP_ARCHS = ("llama3_8b", "granite_moe_1b_a400m", "whisper_small",
              "recurrentgemma_2b", "rwkv6_7b", "internvl2_1b")
REP_ARCHS = ("llama3_8b", "gemma2_2b", "granite_moe_1b_a400m", "rwkv6_7b",
             "whisper_small")
TINY = {kind: InputShape(f"tiny_{kind}", kind, 16, 2)
        for kind in ("train", "prefill", "decode")}


@pytest.fixture(scope="module", autouse=True)
def jax_started(tmp_path_factory):
    """The JAX side, started before this file's first test so that it runs
    while the FLOPs are counted (the tests that read it come last)."""
    out = tmp_path_factory.mktemp("jax_dryrun") / "dump.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT),
                                         env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.Popen(
        [sys.executable, str(HERE / "test_torch_dryrun.py"), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT, start_new_session=True)
    yield proc, out
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()


@pytest.fixture(scope="module")
def jax_dump(jax_started):
    proc, out = jax_started
    try:
        _, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"the JAX side outlived {TIMEOUT} s")
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.read_text())


def test_archs_are_jaxs():
    assert list(ALIASES) == list(JAX_ALIASES)


def test_shard_shape_and_batch_shardings():
    mesh = make_production_mesh(multi_pod=True)
    assert D.shard_shape((256, 4096, 8), (("pod", "data"), None, "model"),
                         {"pod": 2, "data": 16, "model": 4}) == (8, 4096, 2)
    with pytest.raises(ValueError, match="does not split"):
        D.shard_shape((6,), ("model",), mesh)
    meta = torch.device("meta")
    tree = {"tokens": torch.empty(64, 3, device=meta),
            "cache": torch.empty(4, 64, 2, device=meta),
            "odd": torch.empty(3, device=meta)}
    got = D.batch_shardings(tree, mesh, 64)
    assert got == {"tokens": (("pod", "data"),),
                   "cache": (None, ("pod", "data")), "odd": ()}
    assert D.batch_shardings(tree, mesh, 64, baxes=("data", "x")) == {
        "tokens": (("data",),), "cache": (None, ("data",)), "odd": ()}
    assert D.batch_shardings(tree, mesh, 1)["tokens"] == ()


# ------------------------------------------------------------- MalStone
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("backend", D.MALSTONE_BACKENDS)
def test_b10_argument_bytes(tmp_path, backend, multi_pod):
    res = D.run_malstone_cell(backend, "B10", multi_pod, tmp_path)
    got = res["memory_analysis"]["argument_size_in_bytes"]
    assert got == B10[multi_pod]
    cell = f"malstone-B10-{backend}__{'pod2' if multi_pod else 'pod1'}"
    committed = json.loads((ROOT / "results" / "dryrun" /
                            f"{cell}.json").read_text())
    assert got == committed["memory_analysis"]["argument_size_in_bytes"]
    assert res["num_devices"] == committed["num_devices"]
    assert json.loads((tmp_path / f"{cell}.json").read_text()) == res
    assert set(res["not_measured"]) >= {"temp_size_in_bytes",
                                        "collectives"}


@pytest.mark.parametrize("backend", D.MALSTONE_BACKENDS)
def test_backends_read_no_entity_id(backend):
    """Why a record is 12 bytes: rho is the same whatever ``entity_id``
    holds."""
    g = torch.Generator().manual_seed(5)
    n = 4 * 256
    cols = dict(site_id=torch.randint(0, 40, (n,), generator=g,
                                      dtype=torch.int32),
                timestamp=torch.randint(0, 52 * 7 * 86400, (n,),
                                        generator=g, dtype=torch.int32),
                mark=torch.randint(0, 2, (n,), generator=g,
                                   dtype=torch.int32))
    rhos = []
    for ent in (torch.zeros(n, dtype=torch.int32),
                torch.randint(0, 1 << 30, (n,), generator=g,
                              dtype=torch.int32)):
        log = EventLog(entity_id=ent, **cols)
        rhos.append(run(log, 40, nodes=4, backend=backend,
                        device="cpu").rho)
    assert torch.equal(rhos[0].view(torch.int32), rhos[1].view(torch.int32))
    assert set(D.MALSTONE_COLUMNS) | {"entity_id"} == set(
        EventLog._fields[:4])


# ----------------------------------------------------------------- FLOPs
def _real(tree, g):
    """A CPU tensor for every ``meta`` leaf: small normals for floats,
    zeros for integers (token 0, empty caches)."""
    def one(x):
        if x.dtype.is_floating_point:
            return (torch.randn(x.shape, generator=g) * 0.02).to(x.dtype)
        return torch.zeros(x.shape, dtype=x.dtype)

    return tr.tree_unflatten(tree, [one(x) for x in tr.tree_leaves(tree)])


def _count_real(cfg, sh):
    from torch.utils.flop_counter import FlopCounterMode

    fn, args = D.step_and_args(cfg, sh)
    g = torch.Generator().manual_seed(11)
    if sh.kind == "train":
        params, _ = T.init_params(cfg, device="cpu")
        state = S.TrainState(params, adamw_init(params, D._opt_cfg(cfg)))
        args = (state, _real(args[1], g))
    else:
        params, _ = T.init_params(cfg, device="cpu")
        args = (params,) + tuple(_real(a, g) for a in args[1:])
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


@pytest.mark.parametrize("kind", list(TINY))
@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_meta_flops_equal_real_cpu_flops(arch, kind):
    cfg = get_smoke_config(arch)
    sh = TINY[kind]
    meta = D.step_flops(cfg, sh, one_repetition=False)
    assert meta > 0
    assert meta == _count_real(cfg, sh)


@pytest.mark.parametrize("kind", list(TINY))
@pytest.mark.parametrize("arch", REP_ARCHS)
def test_one_repetition_count_equals_direct(arch, kind):
    cfg = get_smoke_config(arch)
    period = cfg.uniform_period
    cfg = dataclasses.replace(cfg, num_layers=3 * period)
    assert cfg.uniform_period == period < cfg.num_layers
    assert D.step_flops(cfg, TINY[kind]) == D.step_flops(
        cfg, TINY[kind], one_repetition=False)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_affine_in_sequence_count_equals_direct(kind):
    """An attention-free model counted at 64 and 128 tokens and
    extrapolated equals the direct count."""
    cfg = dataclasses.replace(get_smoke_config("rwkv6_7b"), num_layers=1)
    assert cfg.is_attention_free
    sh = InputShape(f"longer_{kind}", kind, 192, 1)
    assert sh.seq_len > D.AFFINE_SEQS[1]
    assert D.step_flops(cfg, sh) == D.step_flops(cfg, sh,
                                                 one_repetition=False)


# ------------------------------------------------------------------ main
def test_main_writes_cells(tmp_path, capsys):
    assert D.main(["--arch", "llama3-8b", "--shape", "decode_32k",
                   "--out", str(tmp_path)]) == 0
    res = json.loads((tmp_path / "llama3-8b__decode_32k__pod1.json")
                     .read_text())
    cfg = get_config("llama3-8b")
    assert res["status"] == "ok" and res["num_devices"] == 256
    assert res["flop_counter_flops"] == D.step_flops(cfg, "decode_32k")
    assert res["flop_counter_flops_per_device"] == pytest.approx(
        res["flop_counter_flops"] / 256)
    assert res["model_params_total"] == cfg.num_params_total
    assert res["fits_h100_80gb"] == (
        res["memory_analysis"]["argument_size_in_bytes"] <= 80 * 10**9)
    assert "hlo_hbm_bytes_per_device" in res["not_measured"]
    assert D.main(["--arch", "llama3-8b", "--shape", "long_500k",
                   "--multi-pod", "--out", str(tmp_path)]) == 0
    skipped = json.loads((tmp_path / "llama3-8b__long_500k__pod2.json")
                         .read_text())
    assert skipped["status"] == "skipped"
    assert skipped["reason"] == S.shape_applicable(cfg, "long_500k")[1]
    assert D.main(["--malstone-only", "--both-meshes",
                   "--out", str(tmp_path)]) == 0
    assert len(list(tmp_path.glob("malstone-B10-*.json"))) == 8
    capsys.readouterr()
    assert D.main(["--malstone-only", "--both-meshes", "--skip-existing",
                   "--out", str(tmp_path)]) == 0
    assert capsys.readouterr().out.count("[SKIP-CACHED]") == 8


# ------------------------------------------------------------ against JAX
def test_production_meshes_match_jax(jax_dump):
    for mp in (False, True):
        want = jax_dump["meshes"]["pod2" if mp else "pod1"]
        mesh = make_production_mesh(multi_pod=mp)
        assert [list(kv) for kv in mesh.items()] == want["shape"]
        assert list(batch_axes(mesh)) == want["batch_axes"]


@pytest.mark.parametrize("arch", list(ALIASES))
def test_shards_bytes_and_skips_match_jax(jax_dump, arch):
    """Every leaf's shard shape by path name, the argument bytes a device
    and the skip reasons of the arch's 4 shapes x 2 meshes."""
    cfg = get_config(arch)
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        for shape in S.SHAPES:
            cell = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
            want = jax_dump["cells"][cell]
            ok, reason = S.shape_applicable(cfg, shape)
            if want["status"] == "skipped":
                assert (ok, reason) == (False, want["reason"]), cell
                continue
            assert ok, cell
            with sharding_ctx(mesh,
                              param_overrides=tuple(cfg.sharding_rules),
                              act_overrides=tuple(cfg.act_sharding_rules)):
                _, args, shardings = D.build_lowerable(cfg, shape, mesh)
            got = {path: list(shard) for path, leaf, _, shard
                   in D.leaf_shards(args, shardings, mesh)}
            assert list(got) == list(want["shards"]), cell
            assert got == want["shards"], cell
            assert all(leaf.is_meta for leaf in tr.tree_leaves(args))
            assert D.argument_bytes(args, shardings, mesh) == want[
                "argument_bytes"], cell
