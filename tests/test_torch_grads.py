"""The port's gradients, grad-accumulation step and dry-run contract
against the JAX package's, on the CPU.

From JAX's f32 smoke parameters carried across by path name and one
numpy-seeded batch: every gradient leaf of ``lm_loss`` against
``jax.grad``'s within 2e-3 times the leaf's largest |g|, plus 1e-6 (2e-2
for the MoE, whose backward runs its dispatch products in bf16); the
loss within rtol = atol = 2e-3. ``make_grad_accum_train_step`` over 2
microbatches against JAX's: loss, grad norm and the new parameters within
the same bars.
"""

import jax
import numpy as np
import pytest
import torch

from repro.common.tree import tree_flatten_with_paths as jax_flatten
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import steps as jax_S
from repro.models import transformer as jax_T
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from test_torch_models import (ARCHS, f32, jax_params, make_batch,
                               port_cfg, to_jax, to_torch)

from repro_torch.common.tree import tree_flatten_with_paths
from repro_torch.models import steps as S
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.optim import AdamWConfig, adamw_init

OPT = dict(lr=1e-3, grad_clip=1.0, weight_decay=0.0)
STEP = dict(warmup_steps=1, total_steps=100_000)
SEQ = 16


def _bar(cfg):
    return 2e-2 if cfg.family == "moe" else 2e-3


def _leaf_close(name, got, want, bar):
    """|got - want| within ``bar`` x max |want| + 1e-6; returns the worst
    share of that allowance."""
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    allow = bar * float(np.abs(want).max()) + 1e-6
    worst = float(np.abs(got - want).max()) / allow
    assert worst <= 1.0, f"{name}: {worst:.3f} of the allowance"
    return worst


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(arch):
    """``loss_and_grads`` (the train step's gradient) against JAX's
    ``value_and_grad`` of ``lm_loss``, leaf by leaf in JAX's order; a leaf
    the loss does not reach (whisper's decoder positions) is zero in
    both."""
    jcfg = f32(jax_smoke_config(arch))
    cfg = port_cfg(arch)
    jp, flat = jax_params(jcfg)
    batch = make_batch(cfg, s=SEQ)
    jb = to_jax(batch)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_T.lm_loss(p, jcfg, jb), has_aux=True))(jp)
    p = params_from_numpy(flat, cfg, device="cpu")
    loss, m, grads = S.loss_and_grads(p, cfg, to_torch(batch))
    bar = _bar(cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=bar, atol=bar)
    assert not loss.requires_grad and set(m) == set(jm)
    want = jax_flatten(jg)
    assert len(grads) == len(want)
    names = [n for n, _ in tree_flatten_with_paths(p)]
    assert names == [n for n, _ in want]
    for name, g, (_, w) in zip(names, grads, want):
        assert g.dtype == p_dtype(p, name)
        _leaf_close(name, g, w, bar)
    if cfg.is_encoder_decoder:
        i = names.index("pos/pos")
        assert not grads[i].any() and not np.asarray(want[i][1]).any()


def p_dtype(params, name):
    return dict(tree_flatten_with_paths(params))[name].dtype


@pytest.mark.parametrize("arch", ["llama3_8b", "granite_moe_1b_a400m",
                                  "internvl2_1b", "whisper_small"])
def test_grad_accum_step_matches_jax(arch):
    """Two microbatches of 1 row (patches and frames split with the
    tokens): the mean loss, grad norm, learning rate and every new
    parameter and moment against JAX's ``make_grad_accum_train_step``."""
    jcfg = f32(jax_smoke_config(arch))
    cfg = port_cfg(arch)
    jp, flat = jax_params(jcfg)
    batch = make_batch(cfg, s=SEQ)
    jstate = jax_S.TrainState(jp, jax_adamw_init(jp, JaxAdamWConfig(**OPT)))
    jnew, jm = jax.jit(jax_S.make_grad_accum_train_step(
        jcfg, JaxAdamWConfig(**OPT), 2, **STEP))(jstate, to_jax(batch))
    p = params_from_numpy(flat, cfg, device="cpu")
    state = S.TrainState(p, adamw_init(p, AdamWConfig(**OPT)))
    new, m = S.make_grad_accum_train_step(cfg, AdamWConfig(**OPT), 2,
                                          **STEP)(state, to_torch(batch))
    bar = _bar(cfg)
    assert set(m) == set(jm) == {"loss", "grad_norm", "lr"}
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=bar, atol=bar)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=bar)
    assert int(new.opt.step) == int(jnew.opt.step) == 1
    # the moments hold the accumulated gradient (mu = (1 - b1) g c, nu =
    # (1 - b2) (g c)^2 with c the clip factor); the new parameters move
    # by lr x sign(g) on a first step, which a gradient of rounding noise
    # (a key bias: the softmax does not see it) flips either way
    for field in ("mu", "nu"):
        got = dict(tree_flatten_with_paths(getattr(new.opt, field)))
        for name, w in jax_flatten(getattr(jnew.opt, field)):
            _leaf_close(f"{field}/{name}", got[name], w, bar)
    moved = params_to_numpy(new.params)["embed/table"] - flat["embed/table"]
    assert 0 < np.abs(moved).max() <= 1.01 * OPT["lr"]


def test_a_leaf_split_in_slices_updates_as_one(monkeypatch):
    """AdamW's update of a large leaf a block of rows at a time (a
    stacked 3-dim leaf a slice at a time here, a 2-dim one 2 rows at a
    time) equals the same values updated as whole leaves, and
    ``consume_grads`` empties the list it is given."""
    from repro_torch.optim import adamw as adamw_mod
    from repro_torch.optim import adamw_update

    g = torch.Generator().manual_seed(9)
    cfg = AdamWConfig(weight_decay=0.1)
    table = {"t": torch.randn((7, 4), generator=g)}
    gt = {"t": torch.randn((7, 4), generator=g)}
    whole, _, _ = adamw_update(table, gt, adamw_init(table, cfg), cfg)
    monkeypatch.setattr(adamw_mod, "CHUNK_ELEMS", 8)
    split, _, _ = adamw_update(table, gt, adamw_init(table, cfg), cfg)
    assert torch.equal(split["t"], whole["t"])
    p3 = {"w": torch.randn((3, 4, 5), generator=g)}
    g3 = [torch.randn((3, 4, 5), generator=g)]
    p2 = {f"w{i}": p3["w"][i].clone() for i in range(3)}
    g2 = {f"w{i}": g3[0][i].clone() for i in range(3)}
    n3, s3, m3 = adamw_update(p3, g3, adamw_init(p3, cfg), cfg,
                              consume_grads=True)
    n2, s2, _ = adamw_update(p2, g2, adamw_init(p2, cfg), cfg)
    assert g3 == [None]
    # the grad norm sums the leaves in another order: compare unclipped
    for i in range(3):
        torch.testing.assert_close(n3["w"][i], n2[f"w{i}"], rtol=1e-6,
                                   atol=1e-7)
        torch.testing.assert_close(s3.mu["w"][i], s2.mu[f"w{i}"],
                                   rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError, match="as a list"):
        adamw_update(p2, g2, adamw_init(p2, cfg), cfg, consume_grads=True)
