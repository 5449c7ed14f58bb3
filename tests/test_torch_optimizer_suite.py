"""The port's Momentum, Adagrad, RMSProp, Adadelta, Adamax, Lamb, NAdam and
RAdam against the JAX package's.

Both sides get the same named Paddle-API parameters and, at every step,
the same numpy-seeded gradients (set directly, so only the optimizers are
compared). After every step the parameters and every state-dict entry
must agree within TOL (relative, fp32 on both sides; the port computes
bias corrections in Python floats where the JAX package computes them
in fp32, ROADMAP Queue 3), and the state-dict keys must be the JAX
package's. A JAX optimizer's state, continued on the port for one more
step, must match the JAX optimizer's own next step, with every
parameter's state restored (counted).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer as jopt
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn.parameter import Parameter as JParameter
import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch.nn.parameter import Parameter

TOL = 1e-5
SHAPES = {"fc.weight": (6, 5), "fc.bias": (5,), "out.weight": (5, 3),
          "norm.weight": (3,)}


def _no_bias(p):
    return p.name.endswith("bias")


# name -> (class name, keyword arguments, steps)
CONFIGS = {
    "momentum": ("Momentum", dict(learning_rate=0.05, momentum=0.9,
                                  weight_decay=0.01), 3),
    "momentum_nesterov": ("Momentum", dict(learning_rate=0.05, momentum=0.9,
                                           use_nesterov=True), 3),
    "adagrad": ("Adagrad", dict(learning_rate=0.1, epsilon=1e-6,
                                initial_accumulator_value=0.1,
                                weight_decay=0.01), 3),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01, rho=0.9, epsilon=1e-6,
                                momentum=0.5), 3),
    "rmsprop_centered": ("RMSProp", dict(learning_rate=0.01, rho=0.9,
                                         epsilon=1e-6, momentum=0.5,
                                         centered=True, weight_decay=0.01),
                         3),
    "adadelta": ("Adadelta", dict(learning_rate=1.0, epsilon=1e-6, rho=0.9,
                                  weight_decay=0.01), 3),
    "adamax": ("Adamax", dict(learning_rate=0.01, beta1=0.9, beta2=0.99,
                              weight_decay=0.01), 3),
    "lamb": ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.01,
                          beta1=0.9, beta2=0.99), 3),
    "lamb_exclude": ("Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.1,
                                  exclude_from_weight_decay_fn=_no_bias), 3),
    "nadam": ("NAdam", dict(learning_rate=0.01, beta1=0.9, beta2=0.99,
                            weight_decay=0.01), 3),
    # beta2 0.9 puts rho_t above 5 from step 6: both of RAdam's branches
    "radam": ("RAdam", dict(learning_rate=0.01, beta1=0.9, beta2=0.9,
                            weight_decay=0.01), 7),
}


def _arrays(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {n: (scale * rng.randn(*s)).astype(np.float32)
            for n, s in SHAPES.items()}


def _jax_params(arrays):
    return [JParameter(jnp.asarray(a), name=n) for n, a in arrays.items()]


def _port_params(arrays):
    return [Parameter(torch.from_numpy(a.copy()), name=n)
            for n, a in arrays.items()]


def _jax_step(opt, params, seed):
    for p, g in zip(params, _arrays(seed, scale=0.3).values()):
        p.grad = JTensor(jnp.asarray(g))
    opt.step()
    opt.clear_grad()


def _port_step(opt, params, seed):
    for p, g in zip(params, _arrays(seed, scale=0.3).values()):
        p._data.grad = torch.from_numpy(g)
    opt.step()
    opt.clear_grad()


def _jax_state(opt, params):
    sd = opt.state_dict()
    return ({p.name: np.asarray(p._data) for p in params},
            {k: (np.array(v._data) if hasattr(v, "_data") else v)
             for k, v in sd.items()})


def _port_state(opt, params):
    sd = opt.state_dict()
    return ({p.name: p._data.detach().numpy().copy() for p in params},
            {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
             for k, v in sd.items()})


def _assert_states(got, ref, label):
    (g_params, g_sd), (r_params, r_sd) = got, ref
    assert set(g_sd) == set(r_sd), label
    for key, ref_v in r_sd.items():
        if isinstance(ref_v, np.ndarray):
            np.testing.assert_allclose(g_sd[key], ref_v, rtol=TOL, atol=TOL,
                                       err_msg=f"{key} @ {label}")
        else:
            assert g_sd[key] == ref_v, (key, label)
    for key, ref_v in r_params.items():
        np.testing.assert_allclose(g_params[key], ref_v, rtol=TOL, atol=TOL,
                                   err_msg=f"{key} @ {label}")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_steps_and_state_dict_match_jax(name):
    cls, kw, steps = CONFIGS[name]
    jp, tp = _jax_params(_arrays(0)), _port_params(_arrays(0))
    jo = getattr(jopt, cls)(parameters=jp, **kw)
    to = getattr(topt, cls)(parameters=tp, **kw)
    for step in range(steps):
        _jax_step(jo, jp, 100 + step)
        _port_step(to, tp, 100 + step)
        _assert_states(_port_state(to, tp), _jax_state(jo, jp), step)
    assert to.state_dict()["@step_count"] == steps


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_jax_state_continues_on_the_port(name):
    """Two JAX steps, the JAX state_dict handed to a port optimizer over the
    JAX weights, then one more step on each side."""
    cls, kw, _ = CONFIGS[name]
    jp = _jax_params(_arrays(0))
    jo = getattr(jopt, cls)(parameters=jp, **kw)
    for step in range(2):
        _jax_step(jo, jp, 100 + step)
    j_weights, j_sd = _jax_state(jo, jp)
    tp = _port_params(j_weights)
    to = getattr(topt, cls)(parameters=tp, **kw)
    to.set_state_dict(j_sd)
    restored = sum(1 for p in tp if p.name in to._accumulators)
    assert restored == len(tp)
    assert to._step_count == 2
    _jax_step(jo, jp, 102)
    _port_step(to, tp, 102)
    _assert_states(_port_state(to, tp), _jax_state(jo, jp), "continued")


def test_bf16_parameters_keep_fp32_masters():
    """multi_precision: the master is the fp32 result, the bf16 parameter
    its rounding; the masters under the JAX package's ``{name}_master``
    keys."""
    kw = dict(learning_rate=0.05, momentum=0.9, multi_precision=True)
    jp = [JParameter(jnp.asarray(a).astype(jnp.bfloat16), name=n)
          for n, a in _arrays(0).items()]
    tp = [Parameter(torch.from_numpy(a).to(torch.bfloat16), name=n)
          for n, a in _arrays(0).items()]
    jo, to = jopt.Momentum(parameters=jp, **kw), topt.Momentum(
        parameters=tp, **kw)
    for step in range(3):
        for p, g in zip(jp, _arrays(100 + step, scale=0.3).values()):
            p.grad = JTensor(jnp.asarray(g).astype(jnp.bfloat16))
        jo.step()
        for p, g in zip(tp, _arrays(100 + step, scale=0.3).values()):
            p._data.grad = torch.from_numpy(g).to(torch.bfloat16)
        to.step()
    j_sd, t_sd = jo.state_dict(), to.state_dict()
    assert set(t_sd) == set(j_sd)
    for p in tp:
        master = t_sd[f"{p.name}_master"].numpy()
        np.testing.assert_allclose(
            master, np.asarray(j_sd[f"{p.name}_master"]._data), rtol=TOL,
            atol=TOL)
        torch.testing.assert_close(p._data, torch.from_numpy(master).to(
            torch.bfloat16), atol=0, rtol=0)
