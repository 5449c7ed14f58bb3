"""The registry-wide sweep of the port: every recipe of
``tests/test_op_sweep.py`` (its ``R``, and its ``SKIP`` list with the
reasons) run through both packages on the same numpy inputs.

For each swept op of a category:

* the outputs in fp32, held to the recipe's own ``rtol``/``atol`` (at
  least 1e-5/1e-6), shapes equal and dtypes of one kind;
* for a differentiable float op, the gradients of sum(out * cotangent)
  (a seeded cotangent) with respect to the recipe's float inputs, within
  ``GRAD_RTOL`` of the JAX package's norm-wise;
* for the ops the JAX sweep runs in bf16 (``BF16_SWEPT``), the outputs
  on bf16 inputs, float ones within ``BF16_TOL`` of the JAX package's
  bf16 result (the JAX sweep's own bf16 bound), integral ones equal.

The JAX side of a recipe the JAX sweep also runs under ``jax.jit`` (all
array inputs, ``jit`` set) runs as one jitted program (the outputs and,
through ``jax.value_and_grad``, the gradients), which that sweep holds
equal to its eager path: eagerly each JAX op compiles on its own and
each gradient again. The others run eagerly.

Random recipes cannot match value for value (the two RNGs never agree):
``RANDOM`` holds them to the same shapes and dtypes and to finite
values.
"""
import jax
import jax.numpy as jnp
import numpy as np

import paddle_tpu as jp
import paddle_tpu_torch as tp
import test_op_sweep as S
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.ops.registry import OPS as JOPS
from paddle_tpu_torch.ops.registry import OPS as POPS
from torch_paddle_api import dtype_kind
from paddle_tpu.core.dtype import dtype_name as jax_dtype_name
from paddle_tpu_torch.core.dtype import dtype_name as port_dtype_name

#: norm-wise bound on a gradient against the JAX package's
GRAD_RTOL = 1e-4
#: bf16 outputs against the JAX package's bf16 outputs (the JAX sweep's
#: bound on bf16 against its own f32)
BF16_TOL = 3e-2

#: recipes that draw random numbers: shapes, dtypes and finiteness only
RANDOM = {"gumbel_softmax"}


def swept(categories):
    """The names the JAX sweep runs, of the given registry categories."""
    return [n for n in S.ALL_SWEPT if JOPS[n].category in categories]


def bf16_swept(categories):
    return [n for n in S.BF16_SWEPT if JOPS[n].category in categories]


def _convert(pkg, v, bf16=False):
    """A recipe input as ``pkg`` takes it (the JAX sweep's
    ``_to_tensor``)."""
    if isinstance(v, (list, tuple)) and all(isinstance(x, np.ndarray)
                                            for x in v):
        return [_convert(pkg, x, bf16) for x in v]
    if isinstance(v, np.ndarray):
        t = pkg.to_tensor(np.copy(v))
        if bf16 and v.dtype == np.float32:
            t = t.astype("bfloat16")
        return t
    return v


def leaves(out, pkg):
    if isinstance(out, pkg.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        res = []
        for o in out:
            res.extend(leaves(o, pkg))
        return res
    return []


def _np(t):
    a = np.asarray(t.numpy())
    if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
        a = a.astype(np.float32)
    return a


def _phase(v):
    """Each column of v scaled to make its largest entry real and
    positive (a sign for a real v, a phase for a complex one)."""
    pick = v[np.abs(v).argmax(0), np.arange(v.shape[1])]
    return pick.conj() / np.abs(pick)


def _canonical(name, arrays):
    """Singular vectors are fixed only up to a sign per column: both
    packages' are compared scaled to one choice (``_phase``), U's
    columns and Vh's rows by the same sign."""
    if name == "svd":
        u, s, vh = arrays
        ph = _phase(u)
        return [u * ph[None], s, vh * ph[:, None]]
    return arrays


def _compare(name, js, ps, rtol, atol, what):
    assert len(js) == len(ps), (name, what, len(js), len(ps))
    jarr = _canonical(name, [_np(j) for j in js])
    parr = _canonical(name, [_np(p) for p in ps])
    for k, (j, p) in enumerate(zip(js, ps)):
        assert list(j.shape) == list(p.shape), (name, what, k, j.shape,
                                                p.shape)
        assert dtype_kind(jax_dtype_name(j.dtype)) == dtype_kind(
            port_dtype_name(p.dtype)), (name, what, k, j.dtype, p.dtype)
        if name in RANDOM:
            a = _np(p)
            if np.issubdtype(a.dtype, np.floating):
                assert np.isfinite(a).all(), (name, what)
            continue
        ja, pa = jarr[k], parr[k]
        if np.issubdtype(ja.dtype, np.floating) or np.issubdtype(
                ja.dtype, np.complexfloating):
            np.testing.assert_allclose(pa, ja, rtol=rtol, atol=atol,
                                       err_msg=f"{name}: {what} {k}")
        else:
            np.testing.assert_array_equal(pa, ja,
                                          err_msg=f"{name}: {what} {k}")


#: (values, vectors) decompositions: the recipe's matrix has a repeated
#: eigenvalue, whose eigenvectors are any basis of its eigenspace, so the
#: values are compared and the port's vectors held to A v = w v
EIGEN = ("eig", "eigh")


def _check_eigen(name, a, jout, pout, rtol, atol):
    _compare(name, jout[:1], pout[:1], rtol, atol, "eigenvalues")
    w, v = _np(pout[0]), _np(pout[1])
    resid = np.abs(a @ v - v * w[None]).max()
    assert resid <= 1e-4 * np.abs(a).max(), (name, resid)
    assert list(jout[1].shape) == list(pout[1].shape)


def _jittable(spec):
    return spec["jit"] and all(isinstance(v, np.ndarray)
                               for v in spec["inputs"])


def _grad_idx(name, spec):
    """The inputs whose gradients are compared (none when the JAX sweep
    checks none)."""
    ins = spec["inputs"]
    if not (spec["grad"] and JOPS[name].differentiable
            and name not in RANDOM and all(isinstance(v, np.ndarray)
                                           for v in ins)):
        return []
    if spec["grad_idx"] is not None:
        return list(spec["grad_idx"])
    return [i for i, v in enumerate(ins) if np.issubdtype(v.dtype,
                                                          np.floating)]


def _cotangents(shapes):
    rng = np.random.RandomState(7)
    return [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]


def _jax_jit(name, spec, idx, bf16=False):
    """The JAX outputs (and the gradients of sum(out * cotangent) over
    the float outputs with respect to inputs ``idx``), one program."""
    fn = JOPS[name].lowering
    xs = [jp.to_tensor(np.copy(v))._data for v in spec["inputs"]]
    if bf16:
        xs = [x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x
              for x in xs]

    def run(d_arrays):
        ins = list(xs)
        for i, a in zip(idx, d_arrays):
            ins[i] = a
        outs = [t._data for t in leaves(
            fn(*[JTensor(a) for a in ins], **spec["attrs"]), jp)]
        floats = [o for o in outs if jnp.issubdtype(o.dtype, jnp.floating)]
        loss = sum(jnp.sum(o * c) for o, c in zip(
            floats, _cotangents([o.shape for o in floats]))) if idx else 0.0
        return loss, outs

    (_, outs), grads = jax.jit(jax.value_and_grad(run, has_aux=True))(
        [xs[i] for i in idx])
    return [JTensor(o) for o in outs], [np.asarray(g, np.float64)
                                        for g in grads]


def _port(name, spec, idx, bf16=False):
    """The port's outputs and gradients, eagerly."""
    ts = [_convert(tp, v, bf16) for v in spec["inputs"]]
    for i in idx:
        ts[i].stop_gradient = False
    outs = leaves(POPS[name].lowering(*ts, **spec["attrs"]), tp)
    grads = []
    if idx:
        floats = [o for o in outs if "float" in str(o.dtype)]
        loss = None
        for o, c in zip(floats, _cotangents([tuple(o.shape)
                                             for o in floats])):
            term = (o * tp.to_tensor(c)).sum()
            loss = term if loss is None else loss + term
        loss.backward()
        grads = [None if ts[i].grad is None else
                 ts[i].grad.numpy().astype(np.float64) for i in idx]
    return outs, grads


def _jax_eager(name, spec, idx):
    ts = [_convert(jp, v) for v in spec["inputs"]]
    for i in idx:
        ts[i].stop_gradient = False
    outs = leaves(JOPS[name].lowering(*ts, **spec["attrs"]), jp)
    grads = []
    if idx:
        floats = [o for o in outs if "float" in str(o.dtype)]
        loss = None
        for o, c in zip(floats, _cotangents([tuple(o.shape)
                                             for o in floats])):
            term = (o * jp.to_tensor(c)).sum()
            loss = term if loss is None else loss + term
        loss.backward()
        grads = [None if ts[i].grad is None else
                 np.asarray(ts[i].grad.numpy(), np.float64) for i in idx]
    return outs, grads


def check_fp32(name):
    """Outputs in fp32, and gradients where the JAX sweep checks them."""
    spec = S.R[name]
    rtol, atol = max(spec["rtol"], 1e-5), max(spec["atol"], 1e-6)
    idx = _grad_idx(name, spec)
    with tp.device_guard("cpu"):
        jout, jgrad = (_jax_jit(name, spec, idx) if _jittable(spec)
                       else _jax_eager(name, spec, idx))
        pout, pgrad = _port(name, spec, idx)
        if name in EIGEN:
            _check_eigen(name, spec["inputs"][0], jout, pout, rtol, atol)
        else:
            _compare(name, jout, pout, rtol, atol, "output")
    for i, gj, gp in zip(idx, jgrad, pgrad):
        if gp is None:          # no path from input i: JAX's is all zero
            assert not np.any(gj), (name, i)
            continue
        err = np.linalg.norm(gp - gj) / max(np.linalg.norm(gj), 1e-12)
        assert err <= GRAD_RTOL, (name, i, err)


def check_bf16(name):
    spec = S.R[name]
    with tp.device_guard("cpu"):
        jout, _ = _jax_jit(name, spec, [], bf16=True)
        pout, _ = _port(name, spec, [], bf16=True)
        _compare(name, jout, pout, BF16_TOL, BF16_TOL, "bf16 output")
