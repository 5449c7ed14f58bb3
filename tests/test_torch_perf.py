"""The port's performance attribution (``paddle_tpu_torch.observability
.perf``, the dispatcher's op-cost counters, the capture sites and
``tools/perf_report``) against the JAX package's on the same inputs.

The oracles are the JAX package's own tests (``tests/test_perf.py``):
the cost model's closed forms and its cross-check against a measured
count (XLA's there, FlopCounterMode's here, at the same tolerances), the
step-time attribution, the attributed memory census, the program
capture of ``to_static`` and SOT, the per-op cost counters, the report
and the metrics-dump suffixes. The perf_gate cases are left out: the
port's gate is its benchmark's.
"""
import gc
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.observability import REGISTRY as J_REGISTRY
from paddle_tpu.observability import perf as jperf
from paddle_tpu.observability.perf import costmodel as jcm
from paddle_tpu.observability.perf import device as jdevice
from paddle_tpu.observability.perf import memory as jmemory
from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.observability import REGISTRY as T_REGISTRY
from paddle_tpu_torch.observability import perf as tperf
from paddle_tpu_torch.observability.perf import costmodel as tcm
from paddle_tpu_torch.observability.perf import device as tdevice
from paddle_tpu_torch.observability.perf import memory as tmemory
from paddle_tpu_torch.ops import registry as treg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools import perf_report as jreport  # noqa: E402
from paddle_tpu_torch.tools import perf_report as treport  # noqa: E402

jcm.attach_cost_models()
tcm.attach_cost_models()

#: registry names whose port formula differs from the JAX one on purpose
#: (costmodel's docstring): the JAX table prices the fused loss's
#: cross entropy over x alone, without its projection over the vocabulary
PORT_FORMULA = {"fused_linear_cross_entropy"}
JAX_MODELED = sorted(n for n, od in jreg.OPS.items()
                     if od.cost_fn is not None and n not in PORT_FORMULA)

#: shape sets the formulas take (they read shapes only, so any consistent
#: set prices the same on both packages): 2-D with a bias, 4-D BSHD
#: triples, an NCHW convolution
SHAPE_SETS = (([(4, 8), (8, 6), (6,)], [(4, 6)]),
              ([(2, 8, 3, 16)] * 3, [(2, 8, 3, 16)]),
              ([(2, 3, 9, 9), (5, 3, 3, 3)], [(2, 5, 7, 7)]))
DTYPES = ((np.float32, torch.float32), (jnp.bfloat16, torch.bfloat16))


@pytest.fixture(autouse=True)
def _clean():
    with tp.device_guard("cpu"):
        yield
    for pkg in (jp, tp):
        pkg.set_flags({"FLAGS_enable_metrics": False,
                       "FLAGS_perf_op_cost": False,
                       "FLAGS_perf_capture": False,
                       "FLAGS_benchmark": False})


def _both(name, shapes, attrs=None, outs=(), jdt=np.float32,
          tdt=torch.float32):
    j = jcm.cost_of(name, shapes, [jdt] * len(shapes), attrs, outs)
    t = tcm.cost_of(name, shapes, [tdt] * len(shapes), attrs, outs)
    return j, t


# =========================================================================
# Cost model: every name the JAX package models, the same numbers
# =========================================================================
@pytest.mark.parametrize("name", JAX_MODELED)
def test_cost_model_matches_jax(name):
    assert name in treg.OPS
    for shapes, outs in SHAPE_SETS:
        for jdt, tdt in DTYPES:
            j, t = _both(name, shapes, {}, outs, jdt, tdt)
            assert (j is None) == (t is None), (name, shapes)
            if j is not None:
                assert (t.flops, t.bytes_read, t.bytes_written) == \
                    (j.flops, j.bytes_read, j.bytes_written), (name, shapes)


class TestCostModelClosedForm:
    def test_matmul(self):
        j, t = _both("matmul", [(64, 128), (128, 32)])
        assert t.flops == j.flops == 2 * 64 * 128 * 32
        assert t.bytes_read == j.bytes_read == 4 * (64 * 128 + 128 * 32)

    def test_matmul_transpose_and_batch(self):
        j, t = _both("matmul", [(3, 5, 64), (3, 7, 64)],
                     {"transpose_y": True}, [(3, 5, 7)])
        assert t.flops == j.flops == 2 * 3 * 5 * 64 * 7

    def test_linear_bias(self):
        j, t = _both("linear", [(8, 16), (16, 32), (32,)], {}, [(8, 32)])
        assert t.flops == j.flops == 2 * 8 * 16 * 32 + 8 * 32

    def test_conv2d(self):
        j, t = _both("conv2d", [(2, 3, 16, 16), (8, 3, 3, 3)],
                     {"stride": 1}, [(2, 8, 16, 16)])
        assert t.flops == j.flops == 2 * 2 * 8 * 16 * 16 * 3 * 3 * 3

    def test_attention(self):
        b, s, h, d = 2, 32, 4, 16
        j, t = _both("flash_attention", [(b, s, h, d)] * 3, {},
                     [(b, s, h, d)])
        assert t.flops == j.flops == 4 * b * h * s * s * d + 5 * b * h * s * s
        assert t.bytes == j.bytes == 4 * 4 * b * s * h * d

    def test_layer_norm(self):
        j, t = _both("layer_norm", [(4, 128)])
        assert t.flops == j.flops == 8 * 4 * 128

    def test_bf16_bytes(self):
        j, t = _both("matmul", [(8, 8), (8, 8)], jdt=jnp.bfloat16,
                     tdt=torch.bfloat16)
        assert t.bytes_read == j.bytes_read == 2 * (64 + 64)
        # torch, numpy and dtype-name spellings agree
        assert tcm.dtype_bytes(torch.bfloat16) == \
            tcm.dtype_bytes("bfloat16") == 2
        assert tcm.dtype_bytes(np.float64) == 8

    def test_collectives(self):
        for prim, nbytes, n in (("all_reduce", 1000, 4),
                                ("all_gather", 1000, 4),
                                ("broadcast", 1000, 4),
                                ("all_reduce", 1000, 1),
                                ("reduce_scatter", 4096, 8)):
            assert tcm.collective_cost(prim, nbytes, n).bytes_read == \
                jcm.collective_cost(prim, nbytes, n).bytes_read
        assert tcm.collective_cost("all_reduce", 1000, 4).bytes_read == 1500

    def test_unknown_op_is_none(self):
        assert tcm.cost_of("definitely_not_an_op", [(4,)]) is None

    def test_attach_is_idempotent_and_broad(self):
        n1 = tperf.attach_cost_models()
        n2 = tperf.attach_cost_models()
        assert n1 == n2 >= jperf.attach_cost_models() >= 300
        assert treg.OPS["matmul"].cost_fn is tcm.matmul_cost

    def test_registry_cost_fn_override_wins(self):
        prev = treg.OPS["matmul"].cost_fn
        treg.OPS["matmul"].cost_fn = \
            lambda shapes, dtypes, attrs, outs: tcm.OpCost(flops=42.0)
        try:
            assert tcm.cost_of("matmul", [(4, 4), (4, 4)]).flops == 42.0
        finally:
            treg.OPS["matmul"].cost_fn = prev
        assert tcm.cost_of("matmul",
                           [(4, 4), (4, 4)]).flops == 2 * 4 * 4 * 4

    def test_register_takes_cost_fn(self):
        fn = lambda shapes, dtypes, attrs, outs: tcm.OpCost(flops=7.0)
        treg.register("perf_test_op", "math", cost_fn=fn)(lambda x: x)
        try:
            assert treg.OPS["perf_test_op"].cost_fn is fn
            assert tcm.cost_of("perf_test_op", [(2,)]).flops == 7.0
        finally:
            del treg.OPS["perf_test_op"]

    def test_roofline_bound(self):
        c = tcm.OpCost(flops=1000.0, bytes_read=10.0, bytes_written=10.0)
        r = tcm.roofline_bound(c, peak_flops=1e12, peak_bw=1e11)
        jr = jcm.roofline_bound(jcm.OpCost(1000.0, 10.0, 10.0), 1e12, 1e11)
        assert {k: r[k] for k in jr} == jr
        assert r["bound"] == "compute" and r["attainable_flops"] == 1e12
        assert r["seconds"] == max(1000.0 / 1e12, 20.0 / 1e11)

    # ------------------------------------------ the port's own formulas
    @pytest.mark.parametrize("s_q,s_kv", [(1024, 1024), (1, 128),
                                          (7, 3), (5, 5), (128, 1000)])
    def test_causal_attention_counts_visible_pairs(self, s_q, s_kv):
        pairs = sum(max(0, min(s_kv, i + s_kv - s_q + 1))
                    for i in range(s_q))
        assert tcm.causal_pairs(s_q, s_kv) == pairs
        b, h, d = 2, 3, 64
        c = tcm.cost_of("flash_attention",
                        [(b, s_q, h, d), (b, s_kv, h, d), (b, s_kv, h, d)],
                        [torch.bfloat16] * 3, {"causal": True},
                        [(b, s_q, h, d)])
        assert c.flops == 4 * b * h * pairs * d + 5 * b * h * pairs
        # without the attr: the JAX formula
        j, t = _both("flash_attention",
                     [(b, s_q, h, d), (b, s_kv, h, d), (b, s_kv, h, d)],
                     {}, [(b, s_q, h, d)])
        assert t.flops == j.flops

    def test_fused_linear_cross_entropy_prices_the_projection(self):
        n, h, v = 24, 16, 40
        for w in ((v, h), (h, v)):        # tied (V, H) or (H, V)
            c = tcm.cost_of("fused_linear_cross_entropy",
                            [(n, h), w, (n,)],
                            [torch.float32, torch.float32, torch.int64], {},
                            [()])
            assert c.flops == 2 * n * h * v + 6 * n * v
            assert c.bytes_read == 4 * n * h + 4 * h * v + 8 * n

    def test_attention_backward_formulas(self):
        b, s, h, d = 2, 64, 4, 64
        ins = [(b, s, h, d)] * 4 + [(b, h, s)] * 2
        dts = [torch.bfloat16] * 4 + [torch.float32] * 2
        dq = tcm.cost_of("flash_attention_bwd_dq", ins, dts, {}, ())
        dkv = tcm.cost_of("flash_attention_bwd_dkv", ins, dts,
                          {"causal": True}, ())
        tensor, rows = b * s * h * d * 2, b * h * s * 4
        assert dq.flops == 6 * d * s * s * b * h
        assert dq.bytes == 5 * tensor + 2 * rows
        assert dkv.flops == 8 * d * tcm.causal_pairs(s, s) * b * h
        assert dkv.bytes == 6 * tensor + 2 * rows


# =========================================================================
# Cost model against a measured count (FlopCounterMode; XLA's in JAX)
# =========================================================================
class TestCostModelVsMeasured:
    def _measured(self, fn, *args):
        rec = tdevice.analyze(fn, *args)
        assert rec is not None and rec["flops"] > 0
        return rec

    def test_matmul_flops_exact(self):
        a, b = torch.ones(64, 128), torch.ones(128, 32)
        rec = self._measured(lambda x, y: x @ y, a, b)
        c = tcm.cost_of("matmul", [(64, 128), (128, 32)],
                        [torch.float32] * 2)
        assert tcm.relative_error(c.flops, rec["flops"]) < 0.01
        # bytes: the aten ops' accesses against the model's floor
        assert 0.25 < c.bytes / rec["bytes_accessed"] < 4.0
        assert rec["peak_bytes"] >= 4 * (64 * 128 + 128 * 32 + 64 * 32)

    def test_conv2d_flops(self):
        x, w = torch.ones(2, 3, 16, 16), torch.ones(8, 3, 3, 3)
        rec = self._measured(
            lambda x, w: torch.nn.functional.conv2d(x, w, padding=1), x, w)
        c = tcm.cost_of("conv2d", [(2, 3, 16, 16), (8, 3, 3, 3)],
                        [torch.float32] * 2, {}, [(2, 8, 16, 16)])
        assert tcm.relative_error(c.flops, rec["flops"]) < 0.15

    def test_attention_flops(self):
        b, s, h, d = 2, 32, 4, 16
        q = torch.ones(b, s, h, d)

        def sdpa(q, k, v):
            logits = torch.einsum("bshd,bthd->bhst", q, k) / d ** 0.5
            p = torch.softmax(logits, dim=-1)
            return torch.einsum("bhst,bthd->bshd", p, v)

        rec = self._measured(sdpa, q, q, q)
        c = tcm.cost_of("flash_attention", [(b, s, h, d)] * 3,
                        [torch.float32] * 3, {}, [(b, s, h, d)])
        assert tcm.relative_error(c.flops, rec["flops"]) < 0.10

    def test_k1_op_is_counted(self):
        from paddle_tpu_torch.ops.cuda import flash_attention as fa
        b, s, h, d = 2, 48, 2, 64
        q = torch.randn(b, s, h, d)
        for causal in (False, True):
            rec = self._measured(
                lambda q: fa.flash_attention_fwd(q, q, q, causal=causal)[0],
                q)
            pairs = tcm.causal_pairs(s, s) if causal else s * s
            assert rec["flops"] == 4 * b * h * pairs * d
            c = tcm.cost_of("flash_attention", [(b, s, h, d)] * 3,
                            [torch.float32] * 3, {"causal": causal},
                            [(b, s, h, d)])
            assert tcm.relative_error(c.flops, rec["flops"]) < 0.10


# =========================================================================
# Step-time attribution
# =========================================================================
def _random_spans(seed):
    rng = np.random.RandomState(seed)
    spans = []
    for k in range(3):
        t0 = k * 1.0
        spans.append(("step", "step", t0, t0 + 0.9, 0, None))
        for cat in ("device", "collective", "dispatch", "io", "compile",
                    "serving", "other"):
            for _ in range(rng.randint(0, 4)):
                a = t0 + rng.uniform(-0.1, 0.9)
                spans.append((cat, cat, a, a + rng.uniform(0, 0.4), 0,
                              None))
    return spans


class TestAttribution:
    def test_interval_resolution_priorities(self):
        spans = [
            ("step", "step", 0.0, 1.0, 0, None),
            ("wait", "device", 0.1, 0.5, 0, None),
            ("ar", "collective", 0.2, 0.4, 0, None),
            ("op", "dispatch", 0.6, 0.7, 0, None),
        ]
        out = tdevice.attribute(spans)
        assert out == jdevice.attribute(spans)
        tot = out["total"]
        assert tot["n_steps"] == 1
        assert abs(tot["collective_s"] - 0.2) < 1e-9
        assert abs(tot["compute_s"] - 0.2) < 1e-9
        assert abs(tot["host_s"] - 0.1) < 1e-9
        assert abs(tot["idle_s"] - 0.5) < 1e-9

    @pytest.mark.parametrize("seed", range(4))
    def test_same_dicts_as_jax(self, seed):
        spans = _random_spans(seed)
        assert tdevice.attribute(spans) == jdevice.attribute(spans)
        windows = [(0.2, 0.7), (1.0, 2.5)]
        assert tdevice.attribute(spans, windows) == \
            jdevice.attribute(spans, windows)

    def test_sums_to_step_time_on_train_loop(self):
        tp.seed(0)
        lin = tp.nn.Linear(64, 64)
        opt = tp.optimizer.SGD(learning_rate=0.1,
                               parameters=lin.parameters())
        x = tp.to_tensor(np.random.randn(128, 64).astype(np.float32))

        def step():
            loss = (tp.tanh(lin(x)) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss

        out = tperf.step_attribution(step, iters=3, warmup=1)
        tot = out["total"]
        assert tot["n_steps"] == 3 and tot["host_s"] > 0
        for st in out["steps"] + [tot]:
            parts = (st["compute_s"] + st["collective_s"] + st["host_s"]
                     + st["idle_s"])
            assert abs(parts - st["step_s"]) <= 1e-9 + 1e-9 * st["step_s"]

    def test_measure_and_timed_section_spans(self):
        from paddle_tpu_torch.observability import trace
        x = torch.ones(64, 64)
        assert tdevice.measure(lambda a: a @ a, x, warmup=1, iters=2) > 0
        trace.clear()
        trace.activate()
        try:
            with tdevice.timed_section("s1") as ts:
                ts.track(tp.to_tensor(np.ones((8, 8), np.float32)) * 2)
        finally:
            trace.deactivate()
        cats = {cat for _n, cat, *_ in trace.drain()}
        assert {"device", "step"} <= cats and ts.seconds >= 0


# =========================================================================
# Memory census
# =========================================================================
def _census_delta(memory, build):
    """The census tags a model and one AdamW step add, against the census
    before (other tests' parameters may still be alive)."""
    gc.collect()
    before = memory.census(include_unclaimed=False)
    keep = build()
    gc.collect()
    after = memory.census(include_unclaimed=False)
    return {k: after[k] - before[k] for k in
            ("params", "grads", "optimizer_state", "kv_cache")}, keep


def _linear_step(pkg, state):
    lin = pkg.nn.Linear(32, 32)
    lin.set_state_dict(state)
    opt = pkg.optimizer.AdamW(learning_rate=1e-3,
                              parameters=lin.parameters())
    x = pkg.to_tensor(np.random.RandomState(1).randn(4, 32)
                      .astype(np.float32))
    loss = (lin(x) ** 2).mean()
    loss.backward()
    opt.step()                       # materializes the moments
    return lin, opt


class TestMemoryCensus:
    def test_param_grad_optimizer_same_as_jax(self):
        rng = np.random.RandomState(0)
        state = {"weight": rng.randn(32, 32).astype(np.float32),
                 "bias": rng.randn(32).astype(np.float32)}
        jd, jkeep = _census_delta(jmemory, lambda: _linear_step(jp, state))
        td, tkeep = _census_delta(tmemory, lambda: _linear_step(tp, state))
        assert td == jd
        assert td["params"] == 4 * (32 * 32 + 32)
        assert td["grads"] == td["params"]
        assert td["optimizer_state"] == 2 * td["params"]
        del jkeep, tkeep

    def test_view_shares_storage_counted_once(self):
        a = torch.ones(16)
        pid = tmemory.register_provider(
            "kv_cache", lambda: [a, a[:8], a.view(4, 4), tp.to_tensor(a)])
        try:
            c = tmemory.census(include_unclaimed=False)
            assert c["kv_cache"] == a.nbytes
        finally:
            tmemory.unregister_provider(pid)

    def test_dedup_one_tag_per_buffer(self):
        a = torch.ones(16)
        before = tmemory.census(include_unclaimed=False)
        p1 = tmemory.register_provider("params", lambda: [a])
        p2 = tmemory.register_provider("optimizer_state", lambda: [a])
        try:
            c = tmemory.census(include_unclaimed=False)
            assert c["params"] == before["params"] + a.nbytes
            assert c["optimizer_state"] == before["optimizer_state"]
        finally:
            tmemory.unregister_provider(p1)
            tmemory.unregister_provider(p2)

    def test_provider_dies_with_object(self):
        class Holder:
            def __init__(self):
                self.buf = torch.ones(1024)

        h = Holder()
        tmemory.register_object("kv_cache", h, lambda o: [o.buf])
        assert tmemory.census(include_unclaimed=False)["kv_cache"] >= 4096
        del h
        gc.collect()
        assert tmemory.census(include_unclaimed=False)["kv_cache"] == 0.0

    def test_high_water_per_phase(self):
        tmemory.reset_high_water()
        big = torch.ones(4096)
        pid = tmemory.register_provider("kv_cache", lambda: [big])
        try:
            tmemory.update_high_water("phase_a")
        finally:
            tmemory.unregister_provider(pid)
        tmemory.update_high_water("phase_b")
        hw = tmemory.high_water()
        assert hw["phase_a"] >= big.nbytes
        assert hw["phase_a"] > hw["phase_b"] - 1
        assert tmemory.high_water("phase_a")["kv_cache"] >= big.nbytes

    def test_hbm_metrics_exported(self):
        tp.set_flags({"FLAGS_enable_metrics": True})
        T_REGISTRY.reset()
        tmemory.refresh_metrics()
        snap = T_REGISTRY.snapshot()
        tags = {s["labels"][0]
                for s in snap["paddle_tpu_hbm_live_bytes"]["series"]}
        assert set(tmemory.TAGS) <= tags
        # the CPU has no allocator remainder
        assert tmemory.census()["activations"] == 0.0


# =========================================================================
# Serving
# =========================================================================
class TestServingAttribution:
    def test_kv_cache_is_the_engines_pages(self):
        from paddle_tpu_torch.tools.loadgen import _tiny_engine
        gc.collect()
        base = tmemory.census(include_unclaimed=False)["kv_cache"]
        eng = _tiny_engine(device="cpu")
        pages = sum(t.numel() * t.element_size() for t in eng.kc + eng.vc)
        assert tmemory.census(include_unclaimed=False)["kv_cache"] \
            - base == pages > 0
        del eng
        gc.collect()
        assert tmemory.census(include_unclaimed=False)["kv_cache"] == base

    def test_loadgen_reports_prefill_decode_split(self):
        from paddle_tpu_torch.tools.loadgen import _tiny_engine, run_load
        eng = _tiny_engine(device="cpu")
        eng.warmup()
        rep = run_load(eng, offered_rps=100.0, n_requests=6,
                       max_new_tokens=4, device="cpu")
        eng.drain()
        att = rep["device_attribution"]
        assert att is not None and att["ticks"] > 0
        assert att["prefill_compute_s"] > 0 and att["decode_compute_s"] > 0
        share = att["prefill_compute_share"] + att["decode_compute_share"]
        assert share == pytest.approx(1.0, abs=1e-3)
        assert tmemory.census(include_unclaimed=False)["kv_cache"] > 0


# =========================================================================
# Program capture (to_static / SOT) and the dispatcher's op-cost counters
# =========================================================================
class TestCaptureAndDispatchCost:
    def test_to_static_capture(self):
        tdevice.clear_compiled()
        tp.set_flags({"FLAGS_perf_capture": True})
        tp.seed(0)
        lin = tp.nn.Linear(16, 16)

        @tp.jit.to_static
        def f(x):
            return tp.tanh(lin(x))

        x = tp.to_tensor(np.random.randn(4, 16).astype(np.float32))
        f(x)
        f(x)                                   # a replay: no new record
        progs = tdevice.compiled_programs("to_static")
        assert len(progs) == 1 and progs[0]["n_captures"] == 1
        assert progs[0]["flops"] == 2 * 4 * 16 * 16     # FlopCounterMode
        assert progs[0]["peak_bytes"] > 0
        assert progs[0]["argument_bytes"] >= 4 * (4 * 16 + 16 * 16 + 16)

    def test_sot_capture_on_graph_break(self):
        tdevice.clear_compiled()
        tp.set_flags({"FLAGS_perf_capture": True})
        tp.seed(0)
        lin = tp.nn.Linear(16, 16)

        @tp.jit.to_static
        def g(x):
            y = lin(x)
            if float(y.sum()) > -1e9:      # a host read: SOT
                y = y + 1.0
            return y

        x = tp.to_tensor(np.random.randn(4, 16).astype(np.float32))
        with pytest.warns(UserWarning):
            g(x)
        progs = tdevice.compiled_programs("sot")
        assert progs and progs[0]["flops"] == 2 * 4 * 16 * 16
        assert progs[0]["label"].startswith("site0_ops")

    def test_capture_off_records_nothing(self):
        tdevice.clear_compiled()
        assert not tperf.capture_enabled()

        @tp.jit.to_static
        def f(x):
            return x + 1

        f(tp.to_tensor(np.ones((4,), np.float32)))
        assert tdevice.compiled_programs("to_static") == []

    @staticmethod
    def _program(pkg):
        rng = np.random.RandomState(3)
        a = pkg.to_tensor(rng.randn(32, 64).astype(np.float32))
        b = pkg.to_tensor(rng.randn(64, 16).astype(np.float32))
        y = pkg.matmul(a, b)
        y = pkg.tanh(y + 1.0)
        y = pkg.nn.functional.softmax(y)
        y = pkg.nn.functional.layer_norm(y, 16)
        pkg.matmul(a, b)
        return pkg.sum(y * y)

    def test_op_cost_counters_same_as_jax(self):
        def counters(pkg, registry, perf):
            perf.attach_cost_models()
            pkg.set_flags({"FLAGS_enable_metrics": True,
                           "FLAGS_perf_op_cost": True})
            registry.reset()
            self._program(pkg)
            snap = registry.snapshot()
            return {name: {tuple(s["labels"]): s["value"]
                           for s in snap[name]["series"]}
                    for name in ("paddle_tpu_perf_op_flops_total",
                                 "paddle_tpu_perf_op_bytes_total")}
        want = counters(jp, J_REGISTRY, jperf)
        got = counters(tp, T_REGISTRY, tperf)
        assert got == want
        assert got["paddle_tpu_perf_op_flops_total"][("matmul",)] == \
            2 * (2 * 32 * 64 * 16)

    def test_dispatch_cost_off_by_default(self):
        tp.set_flags({"FLAGS_enable_metrics": True})
        T_REGISTRY.reset()
        a = tp.to_tensor(np.ones((8, 8), np.float32))
        tp.matmul(a, a)
        m = T_REGISTRY.get("paddle_tpu_perf_op_flops_total")
        assert m.value(op="matmul") == 0

    def test_benchmark_flag_reads_no_clock_when_off(self, monkeypatch):
        from paddle_tpu_torch.core import dispatch
        calls = []
        monkeypatch.setattr(dispatch, "_sync_outputs",
                            lambda outs: calls.append(len(outs)))
        a = tp.to_tensor(np.ones((2, 2), np.float32))
        _ = a + a
        assert not calls
        tp.set_flags({"FLAGS_benchmark": True})
        _ = a + a
        assert calls == [1]


# =========================================================================
# perf_report
# =========================================================================
PEAKS = (1e12, 100e9)       # the JAX package's CPU fallbacks


def _sample(report_mod, device):
    op_time = {"matmul": {"calls": 4, "total_s": 0.01},
               "layer_norm": {"calls": 4, "total_s": 0.002}}
    op_cost = {"matmul": {"flops": 4e9, "bytes": 1e8},
               "layer_norm": {"flops": 1e7, "bytes": 2e7}}
    attribution = device.attribute([
        ("step", "step", 0.0, 0.012, 0, None),
        ("wait", "device", 0.0, 0.01, 0, None),
    ])
    kw = {"peaks": PEAKS} if report_mod is treport else {}
    return report_mod.build_report(
        op_time, op_cost, attribution=attribution,
        hbm={"params": 1000, "total": 2000},
        device_info={"device_kind": "sample", "platform": "cpu"}, **kw)


class TestPerfReport:
    def test_build_report_equals_jax(self):
        r = _sample(treport, tdevice)
        assert r == _sample(jreport, jdevice)
        assert r["ops"][0]["op"] == "matmul"
        assert r["ops"][0]["achieved_gflops_per_s"] == pytest.approx(400.0)
        assert "whole_step" in r and r["whole_step"]["mfu"] >= 0

    def test_markdown_headings(self):
        md = treport.render_markdown(_sample(treport, tdevice))
        want = jreport.render_markdown(_sample(jreport, jdevice))
        heads = [ln for ln in md.splitlines() if ln.startswith("#")]
        assert heads == [ln for ln in want.splitlines()
                         if ln.startswith("#")]
        assert md == want
        assert "Per-op roofline" in md and "% roof" in md

    def test_snapshot_roundtrip(self):
        tperf.attach_cost_models()
        tp.set_flags({"FLAGS_enable_metrics": True,
                      "FLAGS_perf_op_cost": True})
        T_REGISTRY.reset()
        a = tp.to_tensor(np.random.randn(16, 16).astype(np.float32))
        tp.matmul(a, a)
        snap = json.loads(json.dumps(T_REGISTRY.snapshot()))
        r = treport.build_report_from_snapshot(snap, peaks=PEAKS)
        rows = {row["op"]: row for row in r["ops"]}
        assert rows["matmul"]["calls"] == 1
        assert rows["matmul"]["model_gflops"] == round(
            2 * 16 ** 3 / 1e9, 4)

    def test_peaks_default_to_the_tables(self):
        r = treport.build_report({}, {}, device_info={"device_kind": "x"})
        assert r["device"]["peak_gflops_per_s"] == round(
            tperf.chip_peak_flops() / 1e9, 1)
        assert tperf.chip_peak_flops("cpu") == 1e12
        assert tperf.PEAK_FLOPS["NVIDIA H100 80GB HBM3"] == 989e12
        assert tperf.PEAK_HBM_BW["NVIDIA H100 80GB HBM3"] == 3.35e12

    def test_demo_on_the_cpu(self):
        r = treport.run_demo(steps=2, hidden=32, batch=2, seq=16,
                             device="cpu")
        ops = {row["op"] for row in r["ops"]}
        assert {"flash_attention", "linear", "cross_entropy"} <= ops
        tot = r["step_attribution"]["total"]
        assert tot["n_steps"] == 2
        assert r["hbm"]["params"] > 0 and r["hbm"]["optimizer_state"] > 0


# =========================================================================
# Metrics-dump process-unique suffix
# =========================================================================
class TestMetricsDumpSuffix:
    @pytest.mark.parametrize("suffix,trainer,primary_self,want", [
        (None, "3", True, "/tmp/m.json.rank3"),
        (None, "0", True, "/tmp/m.json"),
        (None, "2", False, "/tmp/m.json.rank2.pid{pid}"),
        ("worker7", "3", True, "/tmp/m.json.worker7"),
        (None, None, False, "/tmp/m.json.pid{pid}"),
        (None, None, True, "/tmp/m.json"),
    ])
    def test_dump_path_same_as_jax(self, monkeypatch, suffix, trainer,
                                   primary_self, want):
        from paddle_tpu import observability as jobs
        from paddle_tpu_torch import observability as tobs
        for var, v in (("PADDLE_TPU_METRICS_SUFFIX", suffix),
                       ("PADDLE_TRAINER_ID", trainer), ("RANK", None)):
            if v is None:
                monkeypatch.delenv(var, raising=False)
            else:
                monkeypatch.setenv(var, v)
        pid = os.getpid()
        monkeypatch.setenv(tobs._PRIMARY_PID_ENV,
                           str(pid if primary_self else pid + 1))
        got = tobs._dump_path("/tmp/m.json")
        assert got == jobs._dump_path("/tmp/m.json")
        assert got == want.format(pid=pid)

    def test_rank_worker_writes_suffixed_file(self, tmp_path):
        from paddle_tpu_torch import observability as tobs
        dump = tmp_path / "metrics.json"
        env = dict(os.environ, PYTHONPATH=REPO, FLAGS_enable_metrics="1",
                   PADDLE_TPU_METRICS_DUMP=str(dump), PADDLE_TRAINER_ID="2")
        env.pop(tobs._PRIMARY_PID_ENV, None)
        subprocess.run(
            [sys.executable, "-c",
             "import paddle_tpu_torch as p, numpy as np; "
             "p.set_device('cpu'); "
             "a = p.to_tensor(np.ones((4, 4), np.float32)); p.matmul(a, a)"],
            env=env, cwd=REPO, check=True, timeout=120)
        assert not dump.exists()
        snap = json.loads((tmp_path / "metrics.json.rank2").read_text())
        assert "paddle_tpu_dispatch_op_latency_seconds" in snap
        assert "paddle_tpu_hbm_live_bytes" in snap
