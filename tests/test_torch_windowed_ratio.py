"""The port's masked window ratio (K5's plain version, on the CPU) against
the JAX package: its Pallas ``_masked_kernel`` in interpret mode and its
``masked_window_ratio_ref``.

Equality is exact: num and den as integers, rho by its bits. The inputs
are made from a seed with numpy and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.windowed_ratio.ops import (
    masked_window_ratio as jax_masked_window_ratio,
)
from repro.kernels.windowed_ratio.ref import (
    masked_window_ratio_ref as jax_masked_window_ratio_ref,
)
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.windowed_ratio import (
    masked_window_ratio,
    masked_window_ratio_plain,
    masked_window_ratio_ref,
)


def _case(seed, n, w, s, *, high=1000, density=0.5):
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, high, size=(s, w, 2), dtype=np.int32)
    hist[rng.random(s) < 0.2] = 0                   # empty sites
    nm = rng.random((n, w)) < density
    dm = rng.random((n, w)) < density
    return hist, nm, dm


def _port(fn, hist, nm, dm):
    return [x.numpy() for x in fn(torch.from_numpy(hist),
                                  torch.from_numpy(nm),
                                  torch.from_numpy(dm))]


def _jax(fn, hist, nm, dm, **kw):
    return [np.asarray(x) for x in fn(jnp.asarray(hist), jnp.asarray(nm),
                                      jnp.asarray(dm), **kw)]


def _assert_equal(got, want, msg=""):
    for name, a, b in zip(("rho", "num", "den"), got, want):
        assert a.shape == b.shape, f"{name} {msg}"
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=f"{name} {msg}")


@pytest.mark.parametrize("n", (1, 9, 52, 57))
@pytest.mark.parametrize("w,s", ((1, 1), (52, 700), (64, 513), (65, 129)))
def test_masked_window_ratio_matches_jax(n, w, s):
    hist, nm, dm = _case(n * 1000 + w * 10 + s, n, w, s)
    got = _port(masked_window_ratio, hist, nm, dm)
    _assert_equal(got, _jax(jax_masked_window_ratio, hist, nm, dm,
                            interpret=True), "vs the Pallas kernel")
    _assert_equal(got, _jax(jax_masked_window_ratio_ref, hist, nm, dm),
                  "vs masked_window_ratio_ref")
    _assert_equal(got, _port(masked_window_ratio_ref, hist, nm, dm),
                  "vs the port's ref")


def test_zero_denominators_give_zero():
    hist, nm, _ = _case(3, 9, 52, 700)
    dm = np.zeros_like(nm)
    got = _port(masked_window_ratio, hist, nm, dm)
    _assert_equal(got, _jax(jax_masked_window_ratio, hist, nm, dm,
                            interpret=True))
    assert not got[0].any() and not got[2].any() and got[1].any()
    # all masks empty, and an all-zero histogram
    zero = np.zeros_like(hist)
    _assert_equal(_port(masked_window_ratio, zero, nm, nm),
                  _jax(jax_masked_window_ratio_ref, zero, nm, nm))


def test_counts_past_2_24_follow_the_exact_reference():
    """The Pallas body sums in f32: one count of 2^24 + 1 rounds to 2^24
    there. The port (and ``masked_window_ratio_ref``) sum in int32."""
    hist = np.zeros((3, 52, 2), np.int32)
    hist[1, 7] = (2**24 + 1, 2**24 + 1)
    hist[2, :, 0] = 2**20                  # 52 weeks: a sum of 52 * 2^20
    mask = np.ones((1, 52), bool)
    got = _port(masked_window_ratio, hist, mask, mask)
    _assert_equal(got, _jax(jax_masked_window_ratio_ref, hist, mask, mask))
    assert got[1][0, 1] == got[2][0, 1] == 2**24 + 1
    assert got[2][0, 2] == 52 * 2**20
    pallas = _jax(jax_masked_window_ratio, hist, mask, mask, interpret=True)
    assert pallas[1][0, 1] == 2**24, "the Pallas f32 sum no longer rounds"


def test_sums_wrap_as_int32():
    hist, nm, dm = _case(5, 9, 65, 300, high=1 << 27, density=0.9)
    got = _port(masked_window_ratio, hist, nm, dm)
    _assert_equal(got, _jax(jax_masked_window_ratio_ref, hist, nm, dm))
    _assert_equal(got, _port(masked_window_ratio_ref, hist, nm, dm))
    assert (got[1] < 0).any(), "no sum passed 2^31"


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    hist, nm, dm = _case(6, 9, 52, 100)
    reset_launch_counts()
    got = _port(masked_window_ratio, hist, nm, dm)
    assert launch_counts()["windowed_ratio.masked"] == 0
    _assert_equal(got, _port(masked_window_ratio_plain, hist, nm, dm))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    hist = torch.zeros(10, 52, 2, dtype=torch.int32)
    mask = torch.ones(3, 52, dtype=torch.bool)
    bad = [
        (hist.to(torch.int64), mask, mask, "int32"),
        (hist[..., :1], mask, mask, "int32"),
        (hist, mask.to(torch.int32), mask, "bool"),
        (hist, mask[:, :51], mask[:, :51], "bool"),
        (hist, mask, mask[:2], "differ"),
        (hist, mask[:0], mask[:0], "N=0"),
        (hist[:0], mask, mask, "S=0"),
        (hist.transpose(0, 1).contiguous().transpose(0, 1), mask, mask,
         "contiguous"),
        (hist, mask.t().contiguous().t(), mask, "contiguous"),
    ]
    for h, nm, dm, match in bad:
        with pytest.raises(ValueError, match=match):
            masked_window_ratio(h, nm, dm)
