"""The port stands alone: no JAX, no paddle_tpu, no silent CPU.

Every module of ``paddle_tpu_torch`` and ``chip_smoke.py`` is imported in
a fresh interpreter where ``jax`` and ``paddle_tpu`` cannot be imported.
Entry points that were not asked for the CPU must raise where CUDA is
absent, and a CPU call to the flash wrappers, forward or backward,
launches nothing.
"""
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.inference import PagedEngine
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM)
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import fused_ops as FK
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import Router
from paddle_tpu_torch.tools.loadgen import run_load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = GPTConfig(vocab_size=83, hidden_size=64, num_layers=2, num_heads=4,
                 max_seq_len=64)

_IMPORT_ALL = textwrap.dedent("""
    import importlib, pkgutil, sys
    for name in [m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu")]:
        del sys.modules[name]
    sys.modules["jax"] = None          # any import of it now raises
    sys.modules["paddle_tpu"] = None
    import paddle_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        paddle_tpu_torch.__path__, "paddle_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                    and m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
    assert not leaked, leaked
    print(len(names))
""")


def test_imports_without_jax_or_paddle_tpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    # every module was walked: serving, the training slice's functionals,
    # clipping, schedulers and optimizers, the fusion slice's flags,
    # norms, activations, fused ops, LLaMA, fusion pass and to_static,
    # and the serving tier's observability, fault, watchdog, router,
    # stream and tools modules
    assert int(proc.stdout.split()[-1]) >= 65


def test_no_silent_cpu_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GPTForCausalLM(TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paddle_tpu_torch.resolve_device("cuda")
    model = GPTForCausalLM(TINY, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedEngine(model)
    engine = PagedEngine(model, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Router([engine])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_load(engine, offered_rps=1.0, n_requests=1)
    assert engine.queue == [] and engine._ticks == 0
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LlamaForCausalLM(LlamaConfig(vocab_size=83, hidden_size=64,
                                     num_layers=1, num_heads=2))


def test_cpu_flash_call_launches_nothing():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 8, 2, 64), generator=gen) for _ in range(3))
    before = fa.flash_attention_fwd.launches
    fa.flash_attention_fwd(q, k, v, causal=True)
    model = GPTForCausalLM(TINY, device="cpu")
    with torch.inference_mode():
        model(torch.zeros((1, 5), dtype=torch.int64))
    assert fa.flash_attention_fwd.launches == before == 0


def test_cpu_training_step_launches_nothing():
    model = GPTForCausalLM(TINY, device="cpu")
    opt = AdamW(parameters=model.named_parameters())
    ids = torch.zeros((2, 7), dtype=torch.int64)
    _, loss = model(ids, labels=ids)
    loss.backward()
    opt.step()
    assert all(p.device.type == "cpu" for p in opt.state_dict().values()
               if isinstance(p, torch.Tensor))
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == (0, 0, 0)


def test_chip_smoke_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--phases",
                           "build"], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_cpu_fused_training_step_launches_nothing():
    """A fused to_static step on CPU tensors runs the fused ops' plain
    versions: the pass rewrote the graph, and no kernel launched."""
    model = LlamaForCausalLM(LlamaConfig(vocab_size=83, hidden_size=64,
                                         intermediate_size=128, num_layers=2,
                                         num_heads=2), device="cpu")
    paddle_tpu_torch.set_flags({"FLAGS_enable_fusion": True})
    try:
        step = paddle_tpu_torch.to_static(model)
        ids = torch.zeros((2, 7), dtype=torch.int64)
        _, loss = step(ids, labels=ids)
        loss.backward()
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_enable_fusion": False})
    assert step.fusion_stats["rewritten"] == {"rope_proj": 4,
                                              "residual_norm": 4}
    assert (FK.fused_residual_norm.launches, FK.fused_bias_act.launches,
            FK.fused_matmul.launches, FK.fused_matmul_rope.launches,
            fa.flash_attention_fwd.launches) == (0, 0, 0, 0, 0)
