"""The port's AdamW, Adam, gradient clipping and LR schedulers against the
JAX package's.

Both sides get the same parameters and, at every step, the same
numpy-seeded gradients (set on ``.grad`` directly, so the optimizers are
compared and nothing else). After each of 4 steps the parameters, the
moments, the fp32 masters and the learning rate must agree. Parameters
carry the same names on both sides here, so ``apply_decay_param_fun``
and the state-dict keys line up; the end-to-end test in
``test_torch_train.py`` maps the JAX package's counter names instead.

bf16 and int8 moments (``moment_dtype``) and Adam's ``amsgrad`` run the
same comparison within MOMENT_TOL; the int8 encoding gives the JAX
package's codes exactly. The JAX package's AdamW ignores ``amsgrad`` (a
fault of the reference), so the port's AdamW with ``amsgrad`` is held to
``torch.optim.AdamW(amsgrad=True)`` instead.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer as jopt
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.nn import ClipGradByGlobalNorm as JClipGlobal
from paddle_tpu.nn import ClipGradByNorm as JClipNorm
from paddle_tpu.nn import ClipGradByValue as JClipValue
from paddle_tpu.nn.parameter import Parameter as JParameter
from paddle_tpu.optimizer.optimizer import _moment_decode as j_decode
from paddle_tpu.optimizer.optimizer import _moment_encode as j_encode
from paddle_tpu_torch.nn import (ClipGradByGlobalNorm, ClipGradByNorm,
                                 ClipGradByValue)
from paddle_tpu_torch.optimizer import (Adam, AdamW, CosineAnnealingDecay,
                                        LinearWarmup)
from paddle_tpu_torch.optimizer.optimizer import (_moment_decode,
                                                  _moment_encode)

TOL = 1e-6            # fp32 on both sides, the same update rule
MOMENT_TOL = 1e-5     # bf16/int8 moments and amsgrad against the JAX package
STEPS = 4
SHAPES = {"fc.weight": (6, 5), "fc.bias": (5,), "out.weight": (5, 3),
          "norm.weight": (3,)}


def _arrays(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return {n: (scale * rng.randn(*s)).astype(np.float32)
            for n, s in SHAPES.items()}


def _no_bias(name):
    return not name.endswith("bias")


CONFIGS = {
    "plain": dict(kind="adamw", weight_decay=0.0),
    "decay": dict(kind="adamw", weight_decay=0.1),
    "decay_fun": dict(kind="adamw", weight_decay=0.1, decay_fun=True),
    "global_clip": dict(kind="adamw", weight_decay=0.1, clip=0.5),
    "schedule": dict(kind="adamw", weight_decay=0.1, schedule=True),
    "bf16_master": dict(kind="adamw", weight_decay=0.1, dtype="bfloat16"),
    "adam_l2": dict(kind="adam", weight_decay=0.01),
    "bf16_moments": dict(kind="adamw", weight_decay=0.1,
                         moment_dtype="bfloat16"),
    "int8_moments": dict(kind="adamw", weight_decay=0.1, moment_dtype="int8"),
    "int8_moments_bf16_master": dict(kind="adamw", weight_decay=0.1,
                                     moment_dtype="int8", dtype="bfloat16"),
    "adam_int8_l2": dict(kind="adam", weight_decay=0.01, moment_dtype="int8"),
    "adam_amsgrad": dict(kind="adam", weight_decay=0.0, amsgrad=True),
    "adam_amsgrad_bf16_moments": dict(kind="adam", weight_decay=0.01,
                                      amsgrad=True, moment_dtype="bfloat16"),
}


def _schedule(pkg):
    return pkg.LinearWarmup(pkg.CosineAnnealingDecay(1e-2, T_max=6),
                            warmup_steps=2, start_lr=0.0, end_lr=1e-2)


def _make(pkg, cfg, params):
    """An optimizer of ``pkg`` (the JAX package's module or the port's
    names) over ``params`` for configuration ``cfg``; returns it and its
    scheduler (or None)."""
    port = pkg is None
    sched = None
    lr = 1e-2
    if cfg.get("schedule"):
        sched = _schedule(jopt.lr) if not port else LinearWarmup(
            CosineAnnealingDecay(1e-2, T_max=6), warmup_steps=2,
            start_lr=0.0, end_lr=1e-2)
        lr = sched
    clip = None
    if "clip" in cfg:
        clip = (ClipGradByGlobalNorm if port else JClipGlobal)(cfg["clip"])
    multi = cfg.get("dtype") == "bfloat16"
    moments = dict(moment_dtype=cfg.get("moment_dtype"),
                   amsgrad=cfg.get("amsgrad", False))
    if cfg["kind"] == "adam":
        cls = Adam if port else jopt.Adam
        return cls(learning_rate=lr, beta1=0.9, beta2=0.95, parameters=params,
                   weight_decay=cfg["weight_decay"], grad_clip=clip,
                   multi_precision=multi, **moments), sched
    cls = AdamW if port else jopt.AdamW
    return cls(learning_rate=lr, beta1=0.9, beta2=0.95, parameters=params,
               weight_decay=cfg["weight_decay"], grad_clip=clip,
               apply_decay_param_fun=_no_bias if cfg.get("decay_fun")
               else None, multi_precision=multi, **moments), sched


def _run_jax(cfg):
    dtype = jnp.bfloat16 if cfg.get("dtype") else jnp.float32
    params = [JParameter(jnp.asarray(a).astype(dtype), name=n)
              for n, a in _arrays(0).items()]
    opt, sched = _make(jopt, cfg, params)
    trace = []
    for step in range(STEPS):
        for p, g in zip(params, _arrays(100 + step, scale=0.3).values()):
            p.grad = JTensor(jnp.asarray(g).astype(dtype))
        lr = opt.get_lr()
        opt.step()
        opt.clear_grad()
        if sched is not None:
            sched.step()
        sd = opt.state_dict()
        trace.append((lr, {p.name: np.asarray(p._data.astype(jnp.float32))
                           for p in params},
                      {k: np.asarray(v._data) for k, v in sd.items()
                       if hasattr(v, "_data")}))
    return trace


def _run_port(cfg):
    dtype = torch.bfloat16 if cfg.get("dtype") else torch.float32
    named = [(n, torch.nn.Parameter(torch.from_numpy(a).to(dtype)))
             for n, a in _arrays(0).items()]
    opt, sched = _make(None, cfg, named)
    trace = []
    for step in range(STEPS):
        for (_, p), g in zip(named, _arrays(100 + step, scale=0.3).values()):
            p.grad = torch.from_numpy(g).to(dtype)
        lr = opt.get_lr()
        opt.step()
        opt.clear_grad()
        if sched is not None:
            sched.step()
        sd = opt.state_dict()
        trace.append((lr, {n: p.detach().float().numpy().copy()
                           for n, p in named},
                      {k: v.numpy() for k, v in sd.items()
                       if isinstance(v, torch.Tensor)}))
    return trace


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_optimizer_steps_match_jax(name):
    cfg = CONFIGS[name]
    ref, got = _run_jax(cfg), _run_port(cfg)
    tol = MOMENT_TOL if "moment_dtype" in cfg or "amsgrad" in cfg else TOL
    # a bf16 parameter is its fp32 master rounded: allow one rounding step
    p_rtol = 2.0 ** -8 if cfg.get("dtype") else tol
    for step, ((j_lr, j_params, j_state), (lr, params, state)) in enumerate(
            zip(ref, got)):
        assert lr == pytest.approx(j_lr, rel=TOL, abs=TOL), step
        assert set(state) == set(j_state), step
        for key in j_state:
            np.testing.assert_allclose(state[key], j_state[key], atol=tol,
                                       rtol=tol, err_msg=f"{key} @ {step}")
        for key in j_params:
            np.testing.assert_allclose(params[key], j_params[key], atol=tol,
                                       rtol=p_rtol, err_msg=f"{key} @ {step}")
    if cfg.get("schedule"):
        assert got[0][0] == 0.0        # step 1 of a warm-up from 0
        np.testing.assert_array_equal(got[0][1]["fc.weight"],
                                      _arrays(0)["fc.weight"])


def test_state_dict_round_trip_continues_identically():
    cfg = CONFIGS["schedule"]
    named = [(n, torch.nn.Parameter(torch.from_numpy(a)))
             for n, a in _arrays(0).items()]
    opt, sched = _make(None, cfg, named)
    for step in range(2):
        for (_, p), g in zip(named, _arrays(100 + step).values()):
            p.grad = torch.from_numpy(g)
        opt.step()
        sched.step()
    saved = opt.state_dict()
    twin_named = [(n, torch.nn.Parameter(p.detach().clone()))
                  for n, p in named]
    twin, _ = _make(None, cfg, twin_named)
    twin.set_state_dict(saved)
    for o, params in ((opt, named), (twin, twin_named)):
        for (_, p), g in zip(params, _arrays(200).values()):
            p.grad = torch.from_numpy(g)
        o.step()
    for (_, a), (_, b) in zip(named, twin_named):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert twin.get_lr() == opt.get_lr()


def test_scheduler_sequences_match_jax():
    pairs = [
        (_schedule(jopt.lr), LinearWarmup(CosineAnnealingDecay(1e-2, T_max=6),
                                          warmup_steps=2, start_lr=0.0,
                                          end_lr=1e-2)),
        (jopt.lr.LinearWarmup(0.5, warmup_steps=3, start_lr=0.1, end_lr=0.5),
         LinearWarmup(0.5, warmup_steps=3, start_lr=0.1, end_lr=0.5)),
        (jopt.lr.CosineAnnealingDecay(0.2, T_max=5, eta_min=0.01),
         CosineAnnealingDecay(0.2, T_max=5, eta_min=0.01)),
    ]
    for j_sched, sched in pairs:
        j_seq, seq = [], []
        for _ in range(10):
            j_seq.append(j_sched())
            seq.append(sched())
            j_sched.step()
            sched.step()
        np.testing.assert_allclose(seq, j_seq, rtol=1e-12, atol=0)
    assert seq[0] == pytest.approx(0.2)


@pytest.mark.parametrize("kind", ["value", "norm", "global"])
def test_clip_matches_jax(kind):
    grads = _arrays(7, scale=2.0)
    j_clip = {"value": JClipValue(0.5), "norm": JClipNorm(1.0),
              "global": JClipGlobal(1.0)}[kind]
    clip = {"value": ClipGradByValue(0.5), "norm": ClipGradByNorm(1.0),
            "global": ClipGradByGlobalNorm(1.0)}[kind]
    j_pairs = [(JParameter(jnp.zeros(g.shape), name=n),
                JTensor(jnp.asarray(g))) for n, g in grads.items()]
    pairs = [(torch.zeros(g.shape), torch.from_numpy(g))
             for g in grads.values()]
    pairs[1][0].need_clip = False                 # passed through
    j_pairs[1][0].need_clip = False
    for (_, jg), (_, g) in zip(j_clip(j_pairs), clip(pairs)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg._data),
                                   atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(clip(pairs)[1][1].numpy(), grads["fc.bias"])


@pytest.mark.parametrize("kw", [dict(lr_ratio=lambda p: 1.0),
                                dict(weight_decay=object())])
def test_later_slice_options_raise(kw):
    with pytest.raises(NotImplementedError, match="later slice"):
        AdamW(parameters=[torch.nn.Parameter(torch.zeros(2))], **kw)


@pytest.mark.parametrize("shape", [(6, 5), (300,), (3, 256), (1000, 3)])
@pytest.mark.parametrize("nonneg", [False, True])
def test_moment_encode_matches_jax(shape, nonneg):
    """int8 codes equal to the JAX package's, scales within 1 ulp, the
    decoded moments alike; bf16 storage is one rounding of fp32."""
    rng = np.random.RandomState(sum(shape))
    a = (rng.randn(*shape) * rng.choice([1e-3, 1.0, 30.0])).astype(np.float32)
    if nonneg:
        a = a * a
    j = j_encode(jnp.asarray(a), "int8", nonneg)
    t = _moment_encode(torch.from_numpy(a), "int8", nonneg)
    assert t["q"].dtype == torch.int8 and t["q"].shape == (
        -(-a.size // 256), 256)
    np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]))
    np.testing.assert_array_max_ulp(t["s"].numpy(), np.asarray(j["s"]),
                                    maxulp=1)
    np.testing.assert_allclose(
        _moment_decode(t, shape, "int8", nonneg).numpy(),
        np.asarray(j_decode(j, shape, "int8", nonneg)), rtol=1e-6, atol=0)
    b = _moment_encode(torch.from_numpy(a), "bfloat16")
    np.testing.assert_array_equal(
        b.float().numpy(),
        np.asarray(j_encode(jnp.asarray(a), "bfloat16")).astype(np.float32))


@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_amsgrad_with_int8_moments_raises(kind):
    params = [torch.nn.Parameter(torch.zeros(2))]
    j_params = [JParameter(jnp.zeros(2), name="w")]
    cls, j_cls = (Adam, jopt.Adam) if kind == "adam" else (AdamW, jopt.AdamW)
    with pytest.raises(ValueError, match="amsgrad"):
        j_cls(parameters=j_params, amsgrad=True, moment_dtype="int8")
    with pytest.raises(ValueError, match="amsgrad"):
        cls(parameters=params, amsgrad=True, moment_dtype="int8")
    with pytest.raises(ValueError, match="moment_dtype"):
        cls(parameters=params, moment_dtype="float16")


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_adamw_amsgrad_matches_torch(moment_dtype):
    """AdamW with amsgrad against torch.optim.AdamW(amsgrad=True): the
    port's fp32 moments within TOL, bf16 moments within one bf16 rounding
    of v_max's square root."""
    named = [(n, torch.nn.Parameter(torch.from_numpy(a)))
             for n, a in _arrays(0).items()]
    ref = [torch.nn.Parameter(torch.from_numpy(a)) for a in
           _arrays(0).values()]
    opt = AdamW(learning_rate=1e-2, beta1=0.9, beta2=0.95, weight_decay=0.1,
                parameters=named, amsgrad=True, moment_dtype=moment_dtype)
    oracle = torch.optim.AdamW(ref, lr=1e-2, betas=(0.9, 0.95), eps=1e-8,
                               weight_decay=0.1, amsgrad=True)
    for step in range(STEPS):
        # shrinking gradients, so that v falls and its running max matters
        grads = _arrays(100 + step, scale=0.3 / (1 + 3 * step))
        for (_, p), q, g in zip(named, ref, grads.values()):
            p.grad, q.grad = torch.from_numpy(g), torch.from_numpy(g)
        opt.step()
        oracle.step()
    tol = TOL if moment_dtype is None else 1e-3
    for (name, p), q in zip(named, ref):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   atol=tol, rtol=tol, err_msg=name)
    sd = opt.state_dict()
    for (name, _), q in zip(named, ref):
        np.testing.assert_allclose(
            sd[f"{name}_moment2_max"].numpy(),
            oracle.state[q]["max_exp_avg_sq"].numpy(), atol=tol, rtol=10 * tol
            if moment_dtype else tol, err_msg=name)


@pytest.mark.parametrize("moment_dtype", ["bfloat16", "int8"])
def test_moment_state_dict_round_trip(moment_dtype):
    """Checkpoints hold the moments decoded, in fp32; a twin loaded from one
    continues as the original does."""
    cfg = dict(kind="adamw", weight_decay=0.1, moment_dtype=moment_dtype)
    named = [(n, torch.nn.Parameter(torch.from_numpy(a)))
             for n, a in _arrays(0).items()]
    opt, _ = _make(None, cfg, named)
    for step in range(2):
        for (_, p), g in zip(named, _arrays(100 + step).values()):
            p.grad = torch.from_numpy(g)
        opt.step()
    saved = opt.state_dict()
    assert all(v.dtype == torch.float32 for v in saved.values()
               if isinstance(v, torch.Tensor))
    twin_named = [(n, torch.nn.Parameter(p.detach().clone()))
                  for n, p in named]
    twin, _ = _make(None, cfg, twin_named)
    twin.set_state_dict(saved)
    for o, params in ((opt, named), (twin, twin_named)):
        for (_, p), g in zip(params, _arrays(200).values()):
            p.grad = torch.from_numpy(g)
        o.step()
    for (_, a), (_, b) in zip(named, twin_named):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("moment_dtype", [None, "int8"])
def test_grouped_update_is_the_update(moment_dtype, monkeypatch):
    """Updating the parameters in groups (a few at a time, to bound the
    fp32 temporaries) gives bitwise what one group gives."""
    import paddle_tpu_torch.optimizer.optimizer as O
    runs = {}
    for numel in (10, 1 << 26):
        monkeypatch.setattr(O, "_GROUP_NUMEL", numel)
        named = [(n, torch.nn.Parameter(torch.from_numpy(a)))
                 for n, a in _arrays(0).items()]
        opt = AdamW(learning_rate=1e-2, parameters=named, weight_decay=0.1,
                    moment_dtype=moment_dtype)
        for step in range(3):
            for (_, p), g in zip(named, _arrays(100 + step).values()):
                p.grad = torch.from_numpy(g)
            opt.step()
        runs[numel] = [p.detach().clone() for _, p in named]
    for a, b in zip(*runs.values()):
        assert torch.equal(a, b)
