"""The port's train step and its step contract against the JAX package's,
on the CPU.

``make_train_step`` of both packages, from JAX's f32 smoke parameters
carried across by path name, takes three steps on one numpy-seeded batch
(``tests/test_arch_smoke.py:44-64``: lr 1e-3, clip 1.0, no decay, warmup
1). Bars: each step's loss within rtol = atol = 2e-3 and its grad norm
within 2e-3 relative; 2e-2 for the MoE, whose expert choices on the
first step are compared exactly first. The first step's gradients, the
grad-accumulation step and the dry-run contract (``input_specs`` on
``meta``) are held in ``tests/test_torch_grads.py``.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import steps as jax_S
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from test_torch_models import (ARCHS, f32, jax_params, make_batch,
                               port_cfg, recorded_routes, to_jax, to_torch)

from repro_torch.configs import get_config
from repro_torch.models import steps as S
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import AdamWConfig, adamw_init

OPT = dict(lr=1e-3, grad_clip=1.0, weight_decay=0.0)
STEP = dict(warmup_steps=1, total_steps=100_000)
SEQ = 16


def _bar(cfg):
    return 2e-2 if cfg.family == "moe" else 2e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """Three steps on one batch: losses, grad norms and the learning rate
    against JAX's jitted step; the loss falls and the first step moves the
    parameters (``tests/test_arch_smoke.py``'s checks)."""
    jcfg = f32(jax_smoke_config(arch))
    cfg = port_cfg(arch)
    jp, flat = jax_params(jcfg)
    batch = make_batch(cfg, s=SEQ)
    jstate = jax_S.TrainState(jp, jax_adamw_init(jp, JaxAdamWConfig(**OPT)))
    jstep = jax.jit(jax_S.make_train_step(jcfg, JaxAdamWConfig(**OPT),
                                          **STEP))
    p = params_from_numpy(flat, cfg, device="cpu")
    state = S.TrainState(p, adamw_init(p, AdamWConfig(**OPT)))
    step = S.make_train_step(cfg, AdamWConfig(**OPT), **STEP)
    bar = _bar(cfg)
    jb, tb = to_jax(batch), to_torch(batch)
    losses = []
    for i in range(3):
        with recorded_routes() as (jr, tr_):
            jstate, jm = jstep(jstate, jb)
            jax.effects_barrier()
            new, m = step(state, tb)
        if i == 0:
            first = (state, new)
            # both route each layer twice (the forward, and its
            # rematerialisation in the backward), JAX in no fixed order
            # under jit
            assert len(jr) == len(tr_) == (
                2 * cfg.num_layers if cfg.family == "moe" else 0)
            def key(r):
                return r.astype(np.int64).tobytes()

            assert sorted(map(key, tr_)) == sorted(map(key, jr))
            # the port recomputes the layers backwards, as they are
            # differentiated
            half = len(tr_) // 2
            assert all(np.array_equal(a, b) for a, b in
                       zip(tr_[:half], tr_[half:][::-1]))
        state = new
        assert set(m) == set(jm)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=bar, atol=bar)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=bar)
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-7)
        assert float(m["tokens"]) == float(jm["tokens"]) == 2 * SEQ
        losses.append(float(m["loss"]))
    assert losses[2] < losses[0], losses
    before, after = first
    assert int(after.opt.step) == 1 and int(state.opt.step) == 3
    assert not torch.equal(before.params["embed"]["table"],
                           after.params["embed"]["table"])
    # the step is functional: its input state is left as it was
    np.testing.assert_array_equal(
        before.params["embed"]["table"].numpy(), flat["embed/table"])


def test_shape_applicable_matches_jax():
    for arch in ARCHS:
        for shape in S.SHAPES:
            assert S.shape_applicable(get_config(arch), shape) == \
                jax_S.shape_applicable(jax_config(arch), shape), (arch, shape)
    assert S.shape_applicable(get_config("rwkv6_7b"), "long_500k")[0]
    assert not S.shape_applicable(get_config("llama3_8b"), "long_500k")[0]


def test_train_state_and_steps_on_the_cpu_need_asking():
    """``make_train_state`` draws on the device asked for, and the serve
    step builders are thin over ``decoding``."""
    cfg = port_cfg("llama3_8b")
    state, axes = S.make_train_state(
        cfg, AdamWConfig(), device="cpu",
        generator=torch.Generator().manual_seed(4))
    again, _ = S.make_train_state(
        cfg, AdamWConfig(), device="cpu",
        generator=torch.Generator().manual_seed(4))
    assert torch.equal(state.params["embed"]["table"],
                       again.params["embed"]["table"])
    assert state.opt.step.dtype == torch.int32 and int(state.opt.step) == 0
    assert axes["embed"]["table"] == ("vocab", "embed")
    batch = to_torch({k: v for k, v in make_batch(cfg, s=8).items()
                      if k != "labels"})
    last, cache, _ = S.make_prefill_step(cfg, 12)(state.params, batch)
    tok = torch.argmax(last[:, -1], -1)[:, None].to(torch.int32)
    logits, cache = S.make_decode_step(cfg)(state.params, tok, cache)
    assert logits.shape == (2, 1, cfg.padded_vocab)
