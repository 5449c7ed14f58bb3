"""The port's fused kernels (K4-K7) and fused functionals against the JAX
package's.

* Each kernel's plain version (what a CPU tensor runs, and what the card's
  kernel is held to) against the Pallas kernel run in the interpreter
  (``fused_ops.INTERPRET = True``, as ``tests/test_fusion.py`` runs it), in
  fp32 at 1e-5: both norm kinds, every activation, with and without bias,
  rope offsets 0 and 3. The port's weights are torch's (N, K); the JAX
  kernels take (K, N).
* Each ``F.fused_*`` and its composite-recompute gradients against
  ``jax.value_and_grad`` of the JAX functional (its Pallas forward and
  composite backward) at 1e-4.

Widths are multiples of 128 so that the JAX gates send the JAX side
through the Pallas bodies, not its composite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import fused_ops as JK
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional.fused import _residual_norm_composite
from paddle_tpu_torch.ops.cuda import fused_ops as FK

TOL = 1e-5
GRAD_TOL = 1e-4
RNG = np.random.RandomState(3)


@pytest.fixture(autouse=True)
def interpret():
    old = JK.INTERPRET
    JK.INTERPRET = True
    yield
    JK.INTERPRET = old


def arr(*shape, scale=1.0):
    return (RNG.randn(*shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("kind", ["layer_norm", "rms_norm"])
@pytest.mark.parametrize("affine", [True, False])
def test_residual_norm_plain_matches_pallas(kind, affine):
    x, r = arr(20, 256), arr(20, 256)
    w = 1 + arr(256, scale=0.1) if affine else np.ones(256, np.float32)
    b = arr(256, scale=0.1) if affine else np.zeros(256, np.float32)
    want_y, want_s = JK.fused_residual_norm(jnp.asarray(x), jnp.asarray(r),
                                            jnp.asarray(w), jnp.asarray(b),
                                            kind=kind, eps=1e-5)
    y, s = FK.fused_residual_norm(t(x), t(r), t(w) if affine else None,
                                  t(b) if affine else None, kind=kind,
                                  eps=1e-5)
    close(y, want_y)
    close(s, want_s)


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh", "silu", "relu", "none"])
def test_bias_act_plain_matches_pallas(act):
    x, b = arr(24, 256), arr(256, scale=0.5)
    want = JK.fused_bias_act(jnp.asarray(x), jnp.asarray(b), act=act)
    close(FK.fused_bias_act(t(x), t(b), act=act), want)


@pytest.mark.parametrize("norm_kind,act,with_bias", [
    ("", "gelu", True), ("layer_norm", "gelu_tanh", False),
    ("rms_norm", "silu", True), ("layer_norm", "relu", True),
    ("rms_norm", "", False)])
def test_matmul_plain_matches_pallas(norm_kind, act, with_bias):
    x, w = arr(40, 256), arr(256, 128, scale=0.06)
    b = arr(128, scale=0.1)
    nw, nb = 1 + arr(256, scale=0.1), arr(256, scale=0.1)
    want = JK.fused_matmul(
        jnp.asarray(x), jnp.asarray(w),
        jnp.asarray(b) if with_bias else None,
        jnp.asarray(nw) if norm_kind else None,
        jnp.asarray(nb) if norm_kind else None,
        norm_kind=norm_kind, act=act, eps=1e-5)
    got = FK.fused_matmul(t(x), t(w.T), t(b) if with_bias else None,
                          t(nw) if norm_kind else None,
                          t(nb) if norm_kind else None, norm_kind=norm_kind,
                          act=act, eps=1e-5)
    close(got, want)


# One bf16 rounding step of the output, |got - want| <= 2^-7 |want| + 1e-3:
# both sides round an fp32 value whose sums run in another order.
SPLIT_TOL = {"float32": (TOL, TOL), "bfloat16": (1e-3, 2 ** -7)}


def _steps(got, want):
    """How many bf16 steps apart each value of ``got`` is from ``want``'s
    (the bits made two's complement, so neighbours differ by 1)."""
    def ordered(a):
        bits = a.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return (ordered(got) - ordered(want)).abs()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["layer_norm", "rms_norm"])
def test_norm_rows_plain_matches_pallas(kind, dtype):
    """K6's row pass on CPU tensors (its plain version) against the JAX
    ``_normalize_rows`` that the Pallas K6 runs, rounded to x's type: fp32
    to 1e-5; in bf16 (fp32 sums in another order) every value equal, a
    neighbour, or within 2^-20 where the bias cancels the row near 0, and
    at most 1e-3 of them not equal."""
    x = arr(64, 256, scale=2.0) + 0.5
    nw, nb = 1 + arr(256, scale=0.1), arr(256, scale=0.1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj, nwj, nbj = (jnp.asarray(a).astype(jdt).astype(jnp.float32)
                    for a in (x, nw, nb))
    want = JK._normalize_rows(xj, nwj[None], nbj[None], kind, 1e-5).astype(jdt)
    want = t(np.array(want.astype(jnp.float32))).to(tdt)
    got = FK.fused_norm_rows(*(t(a).to(tdt) for a in (x, nw, nb)), kind=kind,
                             eps=1e-5)
    assert got.dtype == tdt and got.shape == want.shape
    if dtype == "float32":
        close(got, want)
    else:
        steps = _steps(got, want)
        diff = (got.float() - want.float()).abs()
        assert not bool(((steps > 1) & (diff > 2 ** -20)).any())
        assert int((steps > 0).sum()) <= 1e-3 * got.numel()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm_kind", ["layer_norm", "rms_norm"])
def test_matmul_norm_split_matches_pallas(norm_kind, dtype):
    """The bf16/fp16 K6 runs its norm as a row pass (``fused_norm_rows``:
    fp32 statistics, scale and shift, round to x's type) and then the
    product with no norm: the plain versions of the two, one after the
    other, are the port's plain K6 and compute the Pallas kernel's
    function, where it rounds included. Held to the Pallas K6 in the
    interpreter, in x's type: the rows sit equal or one rounding apart
    (fp32 sums in another order), the outputs within one rounding of the
    output."""
    x, w = arr(40, 256), arr(256, 128, scale=0.06)
    b, nw, nb = arr(128, scale=0.1), 1 + arr(256, scale=0.1), arr(256,
                                                                 scale=0.1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = JK.fused_matmul(*(jnp.asarray(a).astype(jdt)
                             for a in (x, w, b, nw, nb)),
                           norm_kind=norm_kind, act="gelu_tanh", eps=1e-5)
    xt, wt, bt, nwt, nbt = (t(a).to(tdt) for a in (x, w.T, b, nw, nb))
    xn = FK.fused_norm_rows(xt, nwt, nbt, norm_kind, 1e-5)
    got = FK.fused_matmul_plain(xn, wt, bt, act="gelu_tanh")
    whole = FK.fused_matmul_plain(xt, wt, bt, nwt, nbt, norm_kind,
                                  "gelu_tanh")
    assert torch.equal(got, whole)
    atol, rtol = SPLIT_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("pos_offset", [0, 3])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_matmul_rope_plain_matches_pallas(pos_offset, with_bias, head_dim):
    b_, s = 2, 16
    x, w = arr(b_ * s, 256), arr(256, 256, scale=0.06)
    b = arr(256, scale=0.1)
    want = JK.fused_matmul_rope(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b) if with_bias else None,
                                seq=s, head_dim=head_dim, theta=10000.0,
                                pos_offset=pos_offset)
    got = FK.fused_matmul_rope(t(x), t(w.T), t(b) if with_bias else None,
                               seq=s, head_dim=head_dim, theta=10000.0,
                               pos_offset=pos_offset)
    close(got, want)


def test_cpu_calls_launch_nothing():
    x = torch.randn(8, 64)
    FK.fused_bias_act(x, torch.zeros(64))
    FK.fused_residual_norm(x, x)
    FK.fused_matmul(x, torch.randn(16, 64), norm_kind="rms_norm", act="silu")
    FK.fused_norm_rows(x, kind="rms_norm")
    FK.fused_matmul_rope(x, torch.randn(64, 64), seq=4, head_dim=32)
    assert (FK.fused_bias_act.launches, FK.fused_residual_norm.launches,
            FK.fused_norm_rows.launches, FK.fused_matmul.launches,
            FK.fused_matmul_rope.launches) == (0, 0, 0, 0, 0)


# ------------------------------------------------ functionals and gradients
def _grads_match(jax_fn, torch_fn, arrays, cotangents):
    """Value and every input's gradient of sum(out * cotangent), JAX against
    the port."""
    def jloss(*a):
        outs = jax_fn(*[Tensor(v) for v in a])
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        return sum(jnp.sum(o._data * c) for o, c in zip(outs, cotangents))

    want, want_g = jax.value_and_grad(jloss, tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    leaves = [t(a).requires_grad_() for a in arrays]
    outs = torch_fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * t(c)).sum() for o, c in zip(outs, cotangents))
    got_g = torch.autograd.grad(loss, leaves)
    close(float(loss.detach()), float(want), GRAD_TOL)
    for i, (g, wg) in enumerate(zip(got_g, want_g)):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"input {i}")


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_fused_bias_act_and_grads(act):
    x, b = arr(2, 8, 256), arr(256, scale=0.5)
    _grads_match(lambda x, b: JF.fused_bias_act(x, b, activation=act),
                 lambda x, b: F.fused_bias_act(x, b, activation=act),
                 [x, b], [arr(2, 8, 256)])


@pytest.mark.parametrize("norm_type", ["layer_norm", "rms_norm"])
def test_fused_residual_norm_and_grads(norm_type):
    x, r = arr(2, 8, 128), arr(2, 8, 128)
    w, b = 1 + arr(128, scale=0.1), arr(128, scale=0.1)
    _grads_match(
        lambda x, r, w, b: JF.fused_residual_norm(x, r, w, b,
                                                  norm_type=norm_type),
        lambda x, r, w, b: F.fused_residual_norm(x, r, w, b,
                                                 norm_type=norm_type),
        [x, r, w, b], [arr(2, 8, 128), arr(2, 8, 128)])


@pytest.mark.parametrize("norm_type,act", [("layer_norm", "gelu_tanh"),
                                           ("rms_norm", "silu"), ("", "relu")])
def test_fused_norm_linear_and_grads(norm_type, act):
    x, w, b = arr(2, 8, 256), arr(256, 128, scale=0.06), arr(128, scale=0.1)
    # without a norm there are no norm parameters to differentiate
    norm = [1 + arr(256, scale=0.1), arr(256, scale=0.1)] if norm_type else []
    _grads_match(
        lambda x, w, b, *nwb: JF.fused_norm_linear(
            x, w, b, *nwb, activation=act, norm_type=norm_type),
        # the port takes torch's (N, K) weight
        lambda x, w, b, *nwb: F.fused_norm_linear(
            x, w.t(), b, *nwb, activation=act, norm_type=norm_type),
        [x, w, b] + norm, [arr(2, 8, 128)])


@pytest.mark.parametrize("pos_offset", [0, 3])
def test_fused_rope_proj_and_grads(pos_offset):
    x, w = arr(2, 16, 256), arr(256, 128, scale=0.06)
    _grads_match(
        lambda x, w: JF.fused_rope_proj(x, w, num_heads=2,
                                        pos_offset=pos_offset),
        lambda x, w: F.fused_rope_proj(x, w.t(), num_heads=2,
                                       pos_offset=pos_offset),
        [x, w], [arr(2, 16, 2, 64)])


def test_mixed_dtypes_take_the_composite():
    """A bias of another dtype promotes, as the unfused add does; the
    kernel computes in x's dtype, so that is a different function and the
    composite runs. A residual of another dtype goes with x to their
    promoted dtype, where K4 (here its plain version) computes the
    composite's function."""
    x = torch.randn(4, 64, dtype=torch.bfloat16)
    b = torch.randn(64)
    y = F.fused_bias_act(x, b, activation="relu")
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, torch.relu(x + b))
    n, s = F.fused_residual_norm(x, b.expand(4, 64), norm_type="rms_norm")
    assert n.dtype == s.dtype == torch.float32
    want_n, want_s = _residual_norm_composite(x, b.expand(4, 64), None, None,
                                              "rms_norm", 1e-5)
    torch.testing.assert_close(s, want_s, rtol=0, atol=0)
    torch.testing.assert_close(n, want_n, rtol=1e-5, atol=1e-6)


def test_fused_rope_proj_rejects_a_tensor_offset():
    with pytest.raises(TypeError, match="pos_offset"):
        F.fused_rope_proj(torch.randn(1, 4, 64), torch.randn(64, 64),
                          num_heads=1, pos_offset=torch.tensor(2))
