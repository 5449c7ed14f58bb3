"""Complex tensors on the port against the JAX package: building them
(``complex``, ``polar``, ``as_complex``) and taking them apart
(``real``, ``imag``, ``conj``, ``angle``, ``as_real``), complex64
through arithmetic, reductions, ``abs``/``sgn`` and a cast, the dtype's
name and a complex tensor's ``numpy()``; and a gradient through
``polar`` into real parameters. Values to 1e-6."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core.dtype import dtype_name

TOL = dict(rtol=1e-6, atol=1e-6)
RNG = np.random.RandomState(0)
RE = RNG.randn(3, 4).astype(np.float32)
IM = RNG.randn(3, 4).astype(np.float32)
Z = (RE + 1j * IM).astype(np.complex64)


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def both(fn):
    j, p = fn(jp), fn(tp)
    ja, pa = np.asarray(j.numpy()), p.numpy()
    assert ja.shape == pa.shape and ja.dtype == pa.dtype, (ja.dtype,
                                                          pa.dtype)
    np.testing.assert_allclose(pa, ja, **TOL)
    return p


def test_build():
    z = both(lambda p: p.complex(p.to_tensor(RE), p.to_tensor(IM)))
    assert dtype_name(z.dtype) == "complex64"
    np.testing.assert_allclose(z.numpy(), Z, **TOL)
    both(lambda p: p.polar(p.to_tensor(np.abs(RE)), p.to_tensor(IM)))
    both(lambda p: p.as_complex(p.to_tensor(np.stack([RE, IM], -1))))


@pytest.mark.parametrize("name", ["real", "imag", "conj", "angle",
                                  "as_real", "abs", "sgn", "isreal"])
def test_take_apart(name):
    got = both(lambda p: getattr(p, name)(p.to_tensor(Z)))
    if name not in ("as_real", "isreal", "sgn"):   # the port's methods
        np.testing.assert_array_equal(
            getattr(tp.to_tensor(Z), name)().numpy(), got.numpy())


def test_real_input_parts():
    for name in ("real", "imag", "conj", "angle"):
        both(lambda p: getattr(p, name)(p.to_tensor(RE)))


def test_arithmetic_and_reductions():
    both(lambda p: p.to_tensor(Z) * p.to_tensor(Z) + p.to_tensor(Z))
    both(lambda p: p.to_tensor(Z) / (p.to_tensor(Z) + 2.0))
    both(lambda p: p.sum(p.to_tensor(Z), axis=1))
    both(lambda p: p.mean(p.to_tensor(Z)))
    both(lambda p: p.exp(p.to_tensor(Z)))
    both(lambda p: p.matmul(p.to_tensor(Z), p.to_tensor(Z.T.copy())))


def test_cast_and_dtype_names():
    z = both(lambda p: p.to_tensor(RE).astype("complex64"))
    assert dtype_name(z.dtype) == "complex64"
    z128 = tp.to_tensor(Z.astype(np.complex128))
    assert dtype_name(z128.dtype) == "complex128"
    assert z128.numpy().dtype == np.complex128
    assert tp.is_complex(z) and not tp.is_complex(tp.to_tensor(RE))
    assert tp.is_floating_point(tp.to_tensor(RE))


def test_gradient_through_polar():
    grads = []
    for p in (jp, tp):
        r = p.to_tensor(np.abs(RE), stop_gradient=False)
        th = p.to_tensor(IM, stop_gradient=False)
        z = p.polar(r, th)
        (p.real(z) * 2.0 + p.imag(z)).sum().backward()
        grads.append((r.grad.numpy(), th.grad.numpy()))
    for j, t in zip(*grads):
        np.testing.assert_allclose(t, np.asarray(j), rtol=1e-5, atol=1e-6)
