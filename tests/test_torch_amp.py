"""The port's amp against the JAX package's.

* The op lists are the JAX package's, and ``amp_cast`` casts every op of
  either list (and one of neither) to the dtype the JAX package's
  dispatcher casts it to, for each input dtype, under O1 and O2, bf16 and
  fp16, with custom white and black lists.
* Each port functional that casts returns the dtype the JAX functional
  returns under ``auto_cast`` (O1 bf16, fp32 and bf16 inputs), and one op
  of neither list leaves its inputs alone.
* O2 ``decorate`` casts the same parameters and keeps the same ones fp32
  (LayerNorm yes, RMSNorm no), and sets the optimizers' multi-precision.
* ``GradScaler``: the same scales, the same skipped steps and the same
  weights as the JAX package's over a scripted run of gradients with
  inf/nan planted (growth after ``incr_every_n_steps``, shrinking, the
  floor at 1.0), and a ``state_dict`` round trip.
* ``to_static``: the amp state is part of the cache key, and a trace runs
  each op under the amp state it was traced under.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu import amp as jamp
from paddle_tpu.core import dispatch as jdispatch
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn.parameter import Parameter as JParameter
from paddle_tpu_torch import amp, to_static
from paddle_tpu_torch.amp.state import amp_state
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW

TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16}
TINY_GPT = dict(vocab_size=96, hidden_size=64, num_layers=2, num_heads=2,
                max_seq_len=32)
TINY_LLAMA = dict(vocab_size=96, hidden_size=64, intermediate_size=128,
                  num_layers=2, num_heads=2, max_seq_len=32)


def _name(dtype) -> str:
    return str(np.dtype(dtype)) if not isinstance(dtype, torch.dtype) \
        else str(dtype).replace("torch.", "")


def test_op_lists_are_the_jax_packages():
    assert amp.AMP_WHITE_OPS == jdispatch.AMP_WHITE_OPS
    assert amp.AMP_BLACK_OPS == jdispatch.AMP_BLACK_OPS


@pytest.mark.parametrize("level", ["O1", "O2", "O0"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("custom", ["none", "lists"])
def test_amp_cast_matches_jax_per_op(level, dtype, custom):
    """Every op of either list, and ``gelu`` (neither), each input dtype."""
    white, black = ({"gelu"}, {"matmul"}) if custom == "lists" else ((), ())
    names = sorted(amp.AMP_WHITE_OPS | amp.AMP_BLACK_OPS) + ["gelu"]
    with amp.auto_cast(level=level, dtype=dtype, custom_white_list=white,
                       custom_black_list=black), \
            jamp.auto_cast(level=level, dtype=dtype,
                           custom_white_list=white,
                           custom_black_list=black):
        for name in names:
            for src in TORCH:
                (got,) = amp.amp_cast(name, torch.zeros(2, dtype=TORCH[src]))
                (want,) = jdispatch._amp_cast_inputs(
                    name, [jnp.zeros(2, JNP[src])])
                assert _name(got.dtype) == _name(want.dtype), (name, src)
            (ids,) = amp.amp_cast(name, torch.zeros(2, dtype=torch.int64))
            assert ids.dtype == torch.int64


def _functional_pairs(rng):
    """(name, port call, JAX call) over numpy inputs; weights in each
    package's own layout."""
    x = rng.randn(2, 8, 64).astype(np.float32)
    w = (rng.randn(64, 128) / 8).astype(np.float32)        # JAX (in, out)
    b = rng.randn(128).astype(np.float32)
    nw = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    q = rng.randn(2, 8, 2, 64).astype(np.float32)
    lab = rng.randint(0, 128, 16).astype(np.int64)
    logits = rng.randn(16, 128).astype(np.float32)

    def jt(a):
        return paddle.to_tensor(a)

    def tt(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    return [
        ("linear", lambda c: F.linear(c(x), c(w.T), c(b)),
         lambda c: JF.linear(c(x), c(w), c(b))),
        ("matmul", lambda c: F.matmul(c(x), c(w.T), transpose_y=True),
         lambda c: paddle.matmul(c(x), c(w.T), transpose_y=True)),
        ("flash_attention",
         lambda c: F.flash_attention(c(q), c(q), c(q), causal=True)[0],
         lambda c: JF.flash_attention(c(q), c(q), c(q), causal=True)[0]),
        ("scaled_dot_product_attention",
         lambda c: F.scaled_dot_product_attention(c(q), c(q), c(q)),
         lambda c: JF.scaled_dot_product_attention(c(q), c(q), c(q))),
        ("layer_norm", lambda c: F.layer_norm(c(x), 64, c(nw), c(nw)),
         lambda c: JF.layer_norm(c(x), 64, c(nw), c(nw))),
        ("rms_norm", lambda c: F.rms_norm(c(x), c(nw)),
         lambda c: JF.rms_norm(c(x), c(nw))),
        ("softmax", lambda c: F.softmax(c(x)), lambda c: JF.softmax(c(x))),
        ("cross_entropy",
         lambda c: F.cross_entropy(c(logits), tt(lab)),
         lambda c: JF.cross_entropy(c(logits), jt(lab))),
        ("fused_linear_cross_entropy",
         lambda c: F.fused_linear_cross_entropy(c(x[0]), c(w), tt(lab[:8])),
         lambda c: JF.fused_linear_cross_entropy(c(x[0]), c(w),
                                                 jt(lab[:8]))),
        ("fused_norm_linear",
         lambda c: F.fused_norm_linear(c(x), c(w.T), c(b), c(nw),
                                       norm_type="rms_norm"),
         lambda c: JF.fused_norm_linear(c(x), c(w), c(b), c(nw),
                                        norm_type="rms_norm")),
        ("fused_rope_proj",
         lambda c: F.fused_rope_proj(c(x), c(w.T), num_heads=2),
         lambda c: JF.fused_rope_proj(c(x), c(w), num_heads=2)),
        ("gelu (neither list)", lambda c: F.gelu(c(x)),
         lambda c: JF.gelu(c(x))),
        ("fused_residual_norm (neither list)",
         lambda c: F.fused_residual_norm(c(x), c(x), c(nw))[0],
         lambda c: JF.fused_residual_norm(c(x), c(x), c(nw))[0]),
    ]


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
def test_functional_dtypes_match_jax_under_o1(src):
    rng = np.random.RandomState(1)
    for name, port, jax_fn in _functional_pairs(rng):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            got = port(lambda a: torch.from_numpy(
                np.ascontiguousarray(a)).to(TORCH[src]))
        with jamp.auto_cast(level="O1", dtype="bfloat16"):
            want = jax_fn(lambda a: paddle.to_tensor(a).astype(src))
        assert _name(got.dtype) == _name(want.dtype), name


@pytest.mark.parametrize("family", ["gpt", "llama"])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_decorate_casts_what_jax_casts(family, dtype):
    if family == "gpt":
        jmodel = JaxGPT(JaxGPTConfig(**TINY_GPT))
        tmodel = GPTForCausalLM(GPTConfig(**TINY_GPT), device="cpu")
    else:
        jmodel = JaxLlama(JaxLlamaConfig(**TINY_LLAMA))
        tmodel = LlamaForCausalLM(LlamaConfig(**TINY_LLAMA), device="cpu")
    jparams = [p for p in jmodel.parameters() if not p.stop_gradient]
    jopt_ = jopt.AdamW(parameters=jparams)
    topt = AdamW(parameters=tmodel.named_parameters())
    jmodel, _ = jamp.decorate(jmodel, jopt_, level="O2", dtype=dtype)
    tmodel, _ = amp.decorate(tmodel, topt, level="O2", dtype=dtype)
    want = {k: _name(v.dtype) for k, v in jmodel.state_dict().items()}
    got = {k: _name(v.dtype) for k, v in tmodel.state_dict().items()}
    assert got == want
    kept = {k for k, v in got.items() if v == "float32"}
    assert kept == ({k for k in got if ".ln" in k} if family == "gpt"
                    else set())          # RMSNorm is cast, as in JAX
    assert topt._multi_precision and jopt_._multi_precision
    assert amp.decorate(tmodel, level="O1") is tmodel


# ------------------------------------------------------------- GradScaler
#: per step: which gradient gets an inf or nan planted (None: all finite)
SCRIPT = [None, None, None, ("w", np.inf), None, ("b", np.nan), ("w", np.inf),
          ("b", -np.inf), None, None, None, None, ("w", np.inf), None]


def _scaler_run(port, start=None, steps=SCRIPT):
    """AdamW under a GradScaler (init scale 4, grow x2 after 3 good steps,
    shrink x0.5 after every bad one) over ``steps``; returns per step the
    scale, whether the weights moved, and the weights."""
    rng = np.random.RandomState(2)
    w0 = {"w": rng.randn(4, 3).astype(np.float32),
          "b": rng.randn(3).astype(np.float32)}
    kw = dict(init_loss_scaling=4.0, incr_every_n_steps=3)
    if port:
        params = [(n, torch.nn.Parameter(torch.from_numpy(a)))
                  for n, a in w0.items()]
        opt = AdamW(learning_rate=1e-2, parameters=params)
        scaler = amp.GradScaler(**kw)
    else:
        params = [(n, JParameter(jnp.asarray(a), name=n))
                  for n, a in w0.items()]
        opt = jopt.AdamW(learning_rate=1e-2,
                         parameters=[p for _, p in params])
        scaler = jamp.GradScaler(**kw)
    if start is not None:
        scaler.load_state_dict(start)
    trace = []
    for i, plant in enumerate(steps):
        grads = {n: (rng.randn(*a.shape) * scaler._scale).astype(np.float32)
                 for n, a in w0.items()}
        if plant is not None:
            grads[plant[0]].flat[1] = plant[1]
        before = {n: np.array(_value(p, port)) for n, p in params}
        for n, p in params:
            p.grad = torch.from_numpy(grads[n]) if port \
                else JTensor(jnp.asarray(grads[n]))
        scaler.step(opt)
        opt.clear_grad()
        after = {n: np.array(_value(p, port)) for n, p in params}
        moved = any(not np.array_equal(before[n], after[n]) for n in after)
        trace.append((scaler._scale, moved, after))
    return trace, scaler


def _value(p, port):
    return p.detach().numpy() if port else np.asarray(p._data)


def test_grad_scaler_matches_jax():
    want, _ = _scaler_run(False)
    got, scaler = _scaler_run(True)
    for i, ((js, jm, jw), (s, m, w)) in enumerate(zip(want, got)):
        assert (s, m) == (js, jm), i
        for n in jw:
            np.testing.assert_allclose(w[n], jw[n], atol=1e-6, rtol=1e-6)
    scales = [s for s, _, _ in got]
    assert scales[2] == 8.0 and min(scales) == 1.0    # grew; floored at 1
    assert [m for _, m, _ in got] == [p is None for p in SCRIPT]
    assert scaler.state_dict() == _scaler_run(False)[1].state_dict()


def test_grad_scaler_state_dict_round_trip():
    first, scaler = _scaler_run(True, steps=SCRIPT[:5])
    resumed, _ = _scaler_run(True, start=scaler.state_dict(),
                             steps=SCRIPT[5:])
    j_resumed, _ = _scaler_run(False, start=scaler.state_dict(),
                               steps=SCRIPT[5:])
    assert [s for s, _, _ in resumed] == [s for s, _, _ in j_resumed]
    assert scaler.state_dict()["scale"] == first[-1][0]


def test_grad_scaler_unscales_in_the_grads_dtype():
    p = torch.nn.Parameter(torch.ones(3, dtype=torch.float16))
    opt = AdamW(parameters=[p], multi_precision=True)
    scaler = amp.GradScaler(init_loss_scaling=1024.0)
    loss = scaler.scale((p.float() * 2).sum())
    assert float(loss.detach()) == 6 * 1024
    loss.backward()
    scaler.unscale_(opt)
    assert p.grad.dtype == torch.float16
    torch.testing.assert_close(p.grad, torch.full((3,), 2.0,
                                                  dtype=torch.float16))
    scaler.minimize(opt, scaler.scale((p.float() * 2).sum()))
    assert p.grad is None and scaler._scale == 1024.0
    off = amp.GradScaler(enable=False)
    assert off.scale(loss) is loss and not off.is_enable()


# --------------------------------------------------------------- to_static
def test_to_static_keys_on_the_amp_state():
    model = GPTForCausalLM(GPTConfig(**TINY_GPT), device="cpu")
    sf = to_static(model)
    ids = torch.zeros((1, 8), dtype=torch.int64)
    assert sf(ids).dtype == torch.float32
    first = sf.graph_module
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        assert sf(ids).dtype == torch.bfloat16
    assert sf.graph_module is not first
    with amp.auto_cast(level="O1", dtype="float16"):
        assert sf(ids).dtype == torch.float16
    assert sf(ids).dtype == torch.float32 and sf.graph_module is first


def test_a_trace_runs_each_op_under_its_amp_state():
    """An ``auto_cast(enable=False)`` inside a traced function holds when
    the trace runs, though fx records no context manager."""
    w = torch.randn(8, 4)

    def program(x):
        y = F.linear(x, w)
        with amp.auto_cast(enable=False):
            z = F.linear(x, w)
        return y, z

    sf = to_static(program)
    x = torch.randn(2, 4)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        y, z = sf(x)
    assert (y.dtype, z.dtype) == (torch.bfloat16, torch.float32)
    assert amp_state().level == "O0"
