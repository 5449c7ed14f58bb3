"""The port's regularizers, ASGD, Rprop, LBFGS, per-parameter learning
rates and the rest of ``cross_entropy`` against the JAX package's.

Optimizers: both sides get the same named Paddle-API parameters and, at
every step, the same numpy-seeded gradients (set directly); after every
step the parameters and every state-dict entry agree within TOL
(relative, fp32 on both sides: the Adam-style bound of ROADMAP Queue 3,
the bias corrections being Python floats on the port). Covered: an
``L2Decay``/``L1Decay`` object as ``weight_decay`` (SGD, Momentum, Adam,
ASGD), ``ParamAttr`` regularizers taking priority per parameter (SGD,
Momentum, and AdamW, where they replace the decoupled decay), the
``ParamAttr`` learning rate, ASGD (ring buffer of 3) and Rprop over 5
steps. ``AdamW(lr_ratio=f)`` is held against the JAX AdamW with each
parameter's ``optimize_attr`` learning rate set to f(param): the JAX
AdamW takes ``lr_ratio`` and ignores it (ROADMAP Queue 3), and Paddle's
lr_ratio is that multiplier.

LBFGS runs a closure over a small least-squares problem (3 and 5 steps,
with and without the strong-Wolfe search); the weights and each step's
loss agree within LBFGS_TOL (relative): each step's host-driven
iterations make their decisions on fp32 dot products that round
differently in the two packages.

``cross_entropy``: soft labels (``soft_label=True`` and float labels of
the logits' shape), class weights, ``use_softmax=False``, label
smoothing, ``ignore_index`` and each reduction, values within CE_TOL and
the logits' (and soft labels') gradients within CE_TOL; also through
``nn.CrossEntropyLoss``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpd
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn.parameter import Parameter as JParameter
from paddle_tpu.regularizer import L1Decay as JL1, L2Decay as JL2
import paddle_tpu_torch as tpd
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch.nn.parameter import Parameter
from paddle_tpu_torch.regularizer import L1Decay, L2Decay

TOL = 1e-5
LBFGS_TOL = 1e-4
CE_TOL = 1e-5
SHAPES = {"fc.weight": (6, 5), "fc.bias": (5,), "out.weight": (5, 3),
          "norm.weight": (3,)}


@pytest.fixture(autouse=True)
def _cpu():
    with tpd.device_guard("cpu"):
        yield


def _regs(kind):
    """name -> (port regularizer, JAX regularizer) of a per-parameter
    ``ParamAttr`` case."""
    if kind is None:
        return {}
    return {"fc.weight": (L1Decay(0.05), JL1(0.05)),
            "out.weight": (L2Decay(0.2), JL2(0.2))}


# name -> (class, port kwargs, JAX kwargs, steps, ParamAttr regularizers,
#          ParamAttr learning rates)
CONFIGS = {
    "sgd_l2decay": ("SGD", dict(learning_rate=0.1, weight_decay=L2Decay(0.05)),
                    dict(learning_rate=0.1, weight_decay=JL2(0.05)), 3,
                    None, None),
    "sgd_l1decay": ("SGD", dict(learning_rate=0.1, weight_decay=L1Decay(0.05)),
                    dict(learning_rate=0.1, weight_decay=JL1(0.05)), 3,
                    None, None),
    "momentum_l2decay": ("Momentum",
                         dict(learning_rate=0.05, momentum=0.9,
                              weight_decay=L2Decay(4e-5)),
                         dict(learning_rate=0.05, momentum=0.9,
                              weight_decay=JL2(4e-5)), 3, None, None),
    "adam_l1decay": ("Adam", dict(learning_rate=0.01,
                                  weight_decay=L1Decay(0.01)),
                     dict(learning_rate=0.01, weight_decay=JL1(0.01)), 3,
                     None, None),
    "sgd_paramattr": ("SGD", dict(learning_rate=0.1, weight_decay=0.01),
                      dict(learning_rate=0.1, weight_decay=0.01), 3,
                      "attr", None),
    "momentum_paramattr": ("Momentum",
                           dict(learning_rate=0.05, momentum=0.9,
                                weight_decay=L1Decay(0.01)),
                           dict(learning_rate=0.05, momentum=0.9,
                                weight_decay=JL1(0.01)), 3, "attr", None),
    "adamw_paramattr": ("AdamW", dict(learning_rate=0.01,
                                      weight_decay=0.1),
                        dict(learning_rate=0.01, weight_decay=0.1), 3,
                        "attr", None),
    "sgd_lr_attr": ("SGD", dict(learning_rate=0.1),
                    dict(learning_rate=0.1), 3, None,
                    {"fc.bias": 0.5, "out.weight": 2.0}),
    "asgd": ("ASGD", dict(learning_rate=0.05, batch_num=3),
             dict(learning_rate=0.05, batch_num=3), 5, None, None),
    "asgd_l1decay": ("ASGD", dict(learning_rate=0.05, batch_num=2,
                                  weight_decay=L1Decay(0.02)),
                     dict(learning_rate=0.05, batch_num=2,
                          weight_decay=JL1(0.02)), 4, None, None),
    "rprop": ("Rprop", dict(learning_rate=0.01,
                            learning_rate_range=(1e-4, 0.05),
                            etas=(0.5, 1.2)),
              dict(learning_rate=0.01, learning_rate_range=(1e-4, 0.05),
                   etas=(0.5, 1.2)), 5, None, None),
}


def _arrays(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {n: (scale * rng.randn(*s)).astype(np.float32)
            for n, s in SHAPES.items()}


def _params(arrays, regs=None, lrs=None):
    regs, lrs = _regs(regs), lrs or {}
    jps, tps = [], []
    for n, a in arrays.items():
        reg = regs.get(n, (None, None))
        attr = {"learning_rate": lrs.get(n, 1.0)}
        jps.append(JParameter(jnp.asarray(a), name=n, regularizer=reg[1],
                              optimize_attr=dict(attr)))
        tps.append(Parameter(torch.from_numpy(a.copy()), name=n,
                             regularizer=reg[0], optimize_attr=dict(attr)))
    return jps, tps


def _step(jo, jps, to, tps, seed):
    for jp_, tp_, g in zip(jps, tps, _arrays(seed, scale=0.3).values()):
        jp_.grad = JTensor(jnp.asarray(g))
        tp_._data.grad = torch.from_numpy(g.copy())
    jo.step()
    jo.clear_grad()
    to.step()
    to.clear_grad()


def _assert_same(jo, jps, to, tps, label):
    j_sd = {k: (np.array(v._data) if hasattr(v, "_data") else v)
            for k, v in jo.state_dict().items()}
    t_sd = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in to.state_dict().items()}
    assert set(t_sd) == set(j_sd), label
    for k, ref in j_sd.items():
        if isinstance(ref, np.ndarray):
            np.testing.assert_allclose(np.asarray(t_sd[k], ref.dtype), ref,
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"{k} @ {label}")
        else:
            assert t_sd[k] == ref, (k, label)
    for jp_, tp_ in zip(jps, tps):
        np.testing.assert_allclose(tp_._data.detach().numpy(),
                                   np.asarray(jp_._data), rtol=TOL,
                                   atol=TOL, err_msg=f"{jp_.name} @ {label}")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_steps_match_jax(name):
    cls, tkw, jkw, steps, regs, lrs = CONFIGS[name]
    jps, tps = _params(_arrays(0), regs, lrs)
    jo = getattr(jopt, cls)(parameters=jps, **jkw)
    to = getattr(topt, cls)(parameters=tps, **tkw)
    for s in range(steps):
        _step(jo, jps, to, tps, 100 + s)
        _assert_same(jo, jps, to, tps, s)


@pytest.mark.parametrize("ratio_of", ["bias_half", "by_rank"])
def test_adamw_lr_ratio(ratio_of):
    ratios = {"bias_half": lambda p: 0.5 if p.name.endswith("bias") else 1.0,
              "by_rank": lambda p: 1.0 / len(p.shape)}[ratio_of]
    arrays = _arrays(0)
    jps, tps = _params(arrays)
    for p in jps:
        p.optimize_attr = {"learning_rate": ratios(p)}
    kw = dict(learning_rate=0.01, weight_decay=0.05)
    jo = jopt.AdamW(parameters=jps, **kw)
    to = topt.AdamW(parameters=tps, lr_ratio=ratios, **kw)
    for s in range(3):
        _step(jo, jps, to, tps, 100 + s)
        _assert_same(jo, jps, to, tps, s)


def test_regularizer_objects():
    for pkg in (jpd.regularizer, tpd.regularizer):
        assert pkg.L2Decay(0.25).coeff == 0.25
        assert isinstance(pkg.L1Decay(), pkg.WeightDecayRegularizer)
    assert repr(L2Decay(0.5)) == repr(JL2(0.5))


# ------------------------------------------------------------------ LBFGS
def _lbfgs_problem(pkg, params):
    rng = np.random.RandomState(3)
    a = pkg.to_tensor(rng.randn(12, 6).astype(np.float32))
    b = pkg.to_tensor(rng.randn(12, 3).astype(np.float32))
    w, bias = params

    def closure():
        r = pkg.matmul(a, w) + bias - b
        return (r * r).mean() + 0.01 * (w * w).sum()
    return closure


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
@pytest.mark.parametrize("steps", [3, 5])
def test_lbfgs(line_search, steps):
    rng = np.random.RandomState(0)
    w0 = (0.1 * rng.randn(6, 3)).astype(np.float32)
    b0 = np.zeros(3, np.float32)
    jps = [JParameter(jnp.asarray(w0), name="w"),
           JParameter(jnp.asarray(b0), name="b")]
    tps = [Parameter(torch.from_numpy(w0.copy()), name="w"),
           Parameter(torch.from_numpy(b0.copy()), name="b")]
    kw = dict(learning_rate=0.5 if line_search is None else 1.0,
              max_iter=4, history_size=3, line_search_fn=line_search)
    jo = jopt.LBFGS(parameters=jps, **kw)
    to = topt.LBFGS(parameters=tps, **kw)
    jc, tc = _lbfgs_problem(jpd, jps), _lbfgs_problem(tpd, tps)
    losses = []
    for _ in range(steps):
        lj = float(jo.step(jc).numpy())
        lt = float(to.step(tc).numpy())
        assert abs(lt - lj) <= LBFGS_TOL * max(abs(lj), 1.0)
        losses.append(lt)
        for jp_, tp_ in zip(jps, tps):
            np.testing.assert_allclose(tp_._data.detach().numpy(),
                                       np.asarray(jp_._data),
                                       rtol=LBFGS_TOL, atol=LBFGS_TOL)
    assert losses[-1] < losses[0]


def test_lbfgs_needs_a_closure():
    p = Parameter(torch.zeros(2), name="p")
    with pytest.raises(RuntimeError):
        topt.LBFGS(parameters=[p]).step()


# ---------------------------------------------------------- cross entropy
def _ce_inputs(case):
    rng = np.random.RandomState(7)
    logits = rng.randn(6, 5).astype(np.float32)
    hard = rng.randint(0, 5, 6)
    hard[2] = -100
    soft = rng.rand(6, 5).astype(np.float32)
    soft /= soft.sum(1, keepdims=True)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    weight = rng.rand(5).astype(np.float32) + 0.5
    return dict(logits=logits, hard=hard, soft=soft, probs=probs,
                weight=weight)[case]


CE_CASES = {
    "soft": dict(label="soft", soft_label=True),
    "soft_by_shape": dict(label="soft"),
    "soft_smooth": dict(label="soft", soft_label=True, label_smoothing=0.1),
    "soft_weight": dict(label="soft", soft_label=True, weight=True),
    "hard_weight": dict(label="hard", weight=True),
    "hard_weight_smooth": dict(label="hard", weight=True,
                               label_smoothing=0.2),
    "no_softmax": dict(label="hard", use_softmax=False),
    "no_softmax_weight": dict(label="hard", use_softmax=False, weight=True),
    "no_softmax_smooth": dict(label="hard", use_softmax=False,
                              label_smoothing=0.1),
    "no_softmax_soft": dict(label="soft", soft_label=True,
                            use_softmax=False),
}


def _ce(pkg, case, reduction, layer):
    kw = dict(CE_CASES[case])
    label = _ce_inputs(kw.pop("label"))
    if kw.pop("weight", False):
        kw["weight"] = pkg.to_tensor(_ce_inputs("weight"))
    x_np = _ce_inputs("probs" if kw.get("use_softmax") is False
                      else "logits")
    x = pkg.to_tensor(x_np, stop_gradient=False)
    soft = label.dtype == np.float32
    y = pkg.to_tensor(label, stop_gradient=not kw.get("soft_label", False))
    if layer:
        out = pkg.nn.CrossEntropyLoss(reduction=reduction, **kw)(x, y)
    else:
        out = pkg.nn.functional.cross_entropy(x, y, reduction=reduction,
                                              **kw)
    out.sum().backward()
    grads = [x.grad.numpy()]
    if soft and kw.get("soft_label", False):
        grads.append(y.grad.numpy())
    return np.asarray(out.numpy()), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("layer", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_cross_entropy(case, reduction, layer):
    vj, gj = _ce(jpd, case, reduction, layer)
    vt, gt = _ce(tpd, case, reduction, layer)
    np.testing.assert_allclose(vt, vj, rtol=CE_TOL, atol=CE_TOL)
    assert len(gt) == len(gj)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a, b, rtol=CE_TOL, atol=CE_TOL)
