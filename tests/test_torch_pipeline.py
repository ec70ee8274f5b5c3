"""The port's pipeline parallelism (``repro_torch.distributed``) and its
ring collective against the JAX package's, on the CPU.

- JAX's ``tests/md_scripts/pipeline_check.py`` cases (4 stages of
  ``tanh(x @ w)``, 4 and 8 microbatches of 2, d = 8) and ``lax.ppermute``
  over 4 devices need 4 JAX host devices, so the JAX side runs once in a
  subprocess: this file run as a script (``python
  tests/test_torch_pipeline.py OUT.npz``). The port gets JAX's ``w`` and
  ``x`` and is held within 1e-5, JAX's bar; its ``ppermute`` exactly.
- 2 and 4 stages over a smoke config's blocks (f32, 4 layers) on the
  model's own embedding of seeded tokens against JAX's blocks applied in
  turn to each microbatch (what JAX's ``pipeline_apply`` runs: the MoE
  groups its tokens a microbatch at a time), within JAX's logit bars
  (2e-3, 2e-2 for the MoE, whose dispatch rounds to bf16), and bit-equal
  to the port's own blocks applied a microbatch at a time.
- Gangs of 2 and 4 ranks over gloo (``tools/pipeline_gang.py``, spawned
  as ``tests/test_torch_multiproc.py`` spawns its gangs) bit-equal to
  the one-process run, with the bytes each rank hands to gloo, the
  ``ppermute`` of a rank's rows, and the collectives the recorder saw.
"""

import os
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
S_TOY, MB_TOY, D_TOY = 4, 2, 8
TOY_CASES = ((4, 1), (8, 2))          # (microbatches, x's key), as JAX's
PERMS = {"ring": [(i, (i + 1) % 4) for i in range(4)],
         "partial": [(0, 2), (2, 0)]}


def _jax_main(out_path: str) -> None:
    """The JAX side on 4 forced host devices: the pipeline_check cases and
    ``lax.ppermute`` of seeded rows."""
    from repro.common.env import force_host_devices

    force_host_devices(4)
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from repro.common.compat import shard_map
    from repro.distributed import PipelineConfig, pipeline_apply

    mesh = jax.make_mesh((4,), ("pipe",))
    w = jax.random.normal(jax.random.key(0), (S_TOY, D_TOY, D_TOY)) * 0.3

    def fn(params, x, stage):
        return jnp.tanh(x @ params)

    out = {"w": np.asarray(w)}
    for m, key in TOY_CASES:
        x = jax.random.normal(jax.random.key(key), (m * MB_TOY, D_TOY))
        got = pipeline_apply(fn, w, x, PipelineConfig(S_TOY, m, "pipe"),
                             mesh)
        want = x
        for i in range(S_TOY):
            want = jnp.tanh(want @ w[i])
        out[f"m{m}/x"] = np.asarray(x)
        out[f"m{m}/pipeline"] = np.asarray(got)
        out[f"m{m}/sequential"] = np.asarray(want)
    rows = np.arange(1, 13, dtype=np.float32).reshape(4, 3)
    for name, perm in PERMS.items():
        f = shard_map(lambda r, perm=perm: jax.lax.ppermute(r, "pipe", perm),
                      mesh=mesh, in_specs=P("pipe"), out_specs=P("pipe"),
                      check_vma=False)
        out[f"ppermute/{name}"] = np.asarray(f(jnp.asarray(rows)))
    np.savez(out_path, **out)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
    sys.exit(0)

import dataclasses  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import signal  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import transformer as jax_T  # noqa: E402
from test_torch_models import LOGIT_TOL, MOE_TOL, f32, jax_params  # noqa: E402

from repro_torch.analysis.collective_passes import record_collectives  # noqa: E402
from repro_torch.common import nodes  # noqa: E402
from repro_torch.common import tree as tr  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed import PipelineConfig, pipeline_apply  # noqa: E402
from repro_torch.distributed.pipeline import schedule  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

sys.path.insert(0, str(ROOT / "tools"))
import pipeline_gang  # noqa: E402

TOY_TOL = dict(rtol=1e-5, atol=1e-5)
BLOCK_ARCHS = ("llama3_8b", "granite_moe_1b_a400m")
LAYERS, BATCH, SEQ = 4, 4, 16
TIMEOUT = 240
GANG = dict(stages=4, microbatches=4, batch=4, seq=16, layers=4)


def _env() -> dict:
    e = dict(os.environ)
    e["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT),
                                       e.get("PYTHONPATH", "")])
    e.pop("XLA_FLAGS", None)
    e["JAX_PLATFORMS"] = "cpu"
    return e


def _finish(proc: subprocess.Popen):
    """(returncode, stdout, stderr); the whole session is killed if the
    process outlives the timeout."""
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"{proc.args} outlived {TIMEOUT} s:\n{out}\n{err}")
    return proc.returncode, out, err


def _start(cmd) -> subprocess.Popen:
    return subprocess.Popen(cmd, cwd=ROOT, env=_env(), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True)


GANG_ARGS = ["--arch", "llama3_8b", "--smoke", "--f32", "--device", "cpu",
             "--runs", "1", "--save-output", "--record", "--collectives",
             "--timeout", str(TIMEOUT - 20)] + [
    a for k, v in GANG.items() for a in (f"--{k}", str(v))]


@pytest.fixture(scope="module", autouse=True)
def spawned(tmp_path_factory):
    """The JAX side and the one-process run and gangs of 2 and 4
    (``tools/pipeline_gang.py``), all started before this file's first
    test, so that they run while the blocks are compared."""
    root = tmp_path_factory.mktemp("pipeline")
    procs = {"jax": _start([sys.executable,
                            str(HERE / "test_torch_pipeline.py"),
                            str(root / "jax.npz")])}
    for n in (1, 2, 4):
        procs[n] = _start([sys.executable,
                           str(ROOT / "tools" / "pipeline_gang.py"),
                           "--num-processes", str(n),
                           "--out", str(root / f"n{n}"), *GANG_ARGS])
    yield root, procs
    for proc in procs.values():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()


@pytest.fixture(scope="module")
def jax_side(spawned):
    root, procs = spawned
    rc, _, err = _finish(procs["jax"])
    assert rc == 0, err[-4000:]
    with np.load(root / "jax.npz") as f:
        return dict(f)


@pytest.fixture(scope="module")
def gangs(spawned):
    """rank -> (result, output), by gang size (1: the one-process run)."""
    root, procs = spawned
    out = {}
    for n in (1, 2, 4):
        rc, stdout, stderr = _finish(procs[n])
        assert rc == 0, f"gang of {n} failed:\n{stdout}\n{stderr[-4000:]}"
        out[n] = [(json.loads((root / f"n{n}" / f"rank{r}.json").read_text()),
                   np.load(root / f"n{n}" / f"rank{r}.npz")["out"])
                  for r in range(n)]
    return out


# ------------------------------------------------- a smoke config's blocks
@functools.lru_cache(maxsize=None)
def _jax_blocks(arch):
    cfg = dataclasses.replace(f32(jax_smoke_config(arch)), num_layers=LAYERS)
    p, flat = jax_params(cfg)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                             (BATCH, SEQ), dtype=np.int32)
    x, _ = jax_T._embed_inputs(p, cfg, {"tokens": jnp.asarray(toks)})
    x = np.array(x)
    @jax.jit
    def blocks(layers, h):
        for layer in range(LAYERS):
            lp = jax.tree.map(lambda a, i=layer: a[i], layers)
            h = jax_T.block_apply(lp, cfg, layer, h)
        return h

    # a microbatch at a time, as JAX's pipeline_apply runs fn
    outs = [np.asarray(blocks(p["layers"][0], jnp.asarray(x[k:k + 1])))
            for k in range(BATCH)]
    return flat, x, np.concatenate(outs)


@pytest.mark.parametrize("stages", [2, 4])
@pytest.mark.parametrize("arch", BLOCK_ARCHS)
def test_smoke_blocks_in_stages_match_jax(arch, stages):
    flat, x, want = _jax_blocks(arch)
    cfg = dataclasses.replace(f32(get_smoke_config(arch)), num_layers=LAYERS)
    assert cfg.uniform_period == 1
    layers = params_from_numpy(flat, cfg, device="cpu")["layers"][0]
    per = LAYERS // stages
    staged = tr.tree_unflatten(layers, [
        a.reshape(stages, per, *a.shape[1:]) for a in tr.tree_leaves(layers)])
    fn = pipeline_gang.blocks_fn(cfg, per)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = pipeline_apply(fn, staged, xt,
                             PipelineConfig(stages, num_microbatches=BATCH))
        each = torch.cat([pipeline_gang.sequential(fn, staged, xt[k:k + 1],
                                                   stages)
                          for k in range(BATCH)])
    assert torch.equal(got, each)
    tol = MOE_TOL if cfg.family == "moe" else LOGIT_TOL
    np.testing.assert_allclose(got.numpy(), want, **tol)


# --------------------------------------------- JAX's pipeline_check cases
def _toy_fn(params, x, stage):
    return torch.tanh(x @ params)


@pytest.mark.parametrize("m", [m for m, _ in TOY_CASES])
def test_pipeline_check_cases_match_jax(jax_side, m):
    w = torch.from_numpy(jax_side["w"])
    x = torch.from_numpy(jax_side[f"m{m}/x"])
    got = pipeline_apply(_toy_fn, w, x, PipelineConfig(S_TOY, m, "pipe"))
    assert got.shape == x.shape and got.dtype == x.dtype
    np.testing.assert_allclose(got.numpy(), jax_side[f"m{m}/pipeline"],
                               **TOY_TOL)
    np.testing.assert_allclose(got.numpy(), jax_side[f"m{m}/sequential"],
                               **TOY_TOL)


@pytest.mark.parametrize("name", list(PERMS))
def test_ppermute_equals_lax_ppermute(jax_side, name):
    rows = torch.arange(1, 13, dtype=torch.float32).reshape(4, 3)
    got = nodes.ppermute(rows, None if name == "ring" else PERMS[name])
    assert torch.equal(got, torch.from_numpy(jax_side[f"ppermute/{name}"]))


def test_bad_arguments_raise():
    w = torch.zeros(S_TOY, D_TOY, D_TOY)
    x = torch.zeros(6, D_TOY)
    with pytest.raises(ValueError, match="does not split into 4"):
        pipeline_apply(_toy_fn, w, x, PipelineConfig(S_TOY, 4))
    with pytest.raises(ValueError, match="leading axis of the 4 stages"):
        pipeline_apply(_toy_fn, w[:3], x, PipelineConfig(S_TOY, 2))
    with pytest.raises(ValueError, match="leading axis"):
        pipeline_apply(_toy_fn, {"w": w, "b": torch.zeros(())}, x,
                       PipelineConfig(S_TOY, 2))
    with pytest.raises(ValueError, match="keeps its microbatch"):
        pipeline_apply(lambda p, h, i: h.double(), w, x,
                       PipelineConfig(S_TOY, 2))
    with pytest.raises(ValueError, match="over 2 nodes"):
        pipeline_apply(_toy_fn, w, x, PipelineConfig(S_TOY, 2),
                       nodes.NodeGroup(2))
    with pytest.raises(ValueError, match="twice"):
        nodes.ppermute(torch.zeros(4, 1), [(0, 1), (2, 1)])


def test_schedule_is_jaxs():
    """Stage i runs microbatch t - i at tick t, over m + s - 1 ticks: each
    (stage, microbatch) pair exactly once."""
    s, m = 4, 8
    runs = [(i, k, t) for t in range(m + s - 1) for i, k in schedule(s, m, t)]
    assert sorted((i, k) for i, k, _ in runs) == [
        (i, k) for i in range(s) for k in range(m)]
    assert all(t == i + k for i, k, t in runs)


# ------------------------------------------------------------------ the gangs
@pytest.mark.parametrize("ranks", [2, 4])
def test_gang_bit_equals_one_process(gangs, ranks):
    one, want = gangs[1][0]
    row = GANG["seq"] * 64 * 4            # a microbatch of one: f32 bytes
    for r, (res, got) in enumerate(gangs[ranks]):
        assert res["digest"] == one["digest"]
        assert got.tobytes() == want.tobytes()
        per = GANG["stages"] // ranks
        assert res["stages"] == list(range(r * per, (r + 1) * per))
        sent = GANG["microbatches"] * row if r < ranks - 1 else 0
        assert res["clock"]["bytes"] == sent + want.nbytes


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_gang_ppermute_equals_one_process(gangs, ranks):
    s = GANG["stages"]
    rows = pipeline_gang.collective_input(s)
    ring = nodes.ppermute(rows)
    partial = nodes.ppermute(rows, pipeline_gang.partial_perm(s))
    assert torch.equal(ring, torch.roll(rows, 1, 0))
    assert partial[1::2].eq(0).all()
    per = s // ranks
    for r, (res, _) in enumerate(gangs[ranks]):
        mine = slice(r * per, (r + 1) * per)
        assert res["ppermute_ring"] == ring[mine].tolist()
        assert res["ppermute_partial"] == partial[mine].tolist()


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_recorder_sees_the_ring(gangs, ranks):
    """Every rank records the same collectives: a ``ppermute`` of one row
    each tick that hands a microbatch across ranks, staged through gloo on
    the ranks that send or receive, then the last stage's ``broadcast``."""
    s, m = GANG["stages"], GANG["microbatches"]
    per = s // ranks
    ticks = [t for t in range(m + s - 1)
             if any(i < s - 1 and (i + 1) % per == 0
                    for i, _ in schedule(s, m, t))] if ranks > 1 else []
    records = [res["records"] for res, _ in gangs[ranks]]
    sigs = [[(d["op"], d["dtype"], tuple(d["shape"])) for d in rec]
            for rec in records]
    assert all(sig == sigs[0] for sig in sigs)
    mb = (1, GANG["seq"], 64)
    out = (m,) + mb
    assert sigs[0] == [("ppermute", "float32", (1,) + mb)] * len(ticks) + [
        ("broadcast", "float32", out)]
    for r, rec in enumerate(records):
        for t, d in zip(ticks, rec):
            # rank r sends at t if its last stage ran; receives if the
            # stage before its first ran
            moved = any(i in (r * per - 1, (r + 1) * per - 1)
                        and i < s - 1 for i, _ in schedule(s, m, t))
            assert d["gloo"] == moved and d["world"] == ranks
        assert rec[-1]["gloo"] == (ranks > 1)


def test_recorder_records_a_one_process_ppermute():
    with record_collectives() as recs:
        nodes.ppermute(torch.zeros(4, 2, dtype=torch.bfloat16))
    assert [(r.op, r.dtype, r.shape, r.bytes, r.gloo) for r in recs] == [
        ("ppermute", "bfloat16", (4, 2), 16, False)]
