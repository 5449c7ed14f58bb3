"""The port stands alone: no JAX, no paddle_tpu, no silent CPU.

Every module of ``paddle_tpu_torch`` and ``chip_smoke.py`` is imported in
a fresh interpreter where ``jax``, ``paddle_tpu`` and ``ml_dtypes`` (the
card's machine does not have it; the port reads and writes bf16
checkpoints without it) cannot be imported.
Entry points that were not asked for the CPU must raise where CUDA is
absent (the Paddle API's too: ``to_tensor``, a ``Layer``, BERT, with no
``set_device("cpu")``), and a CPU call to the flash wrappers, forward or
backward, launches nothing.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
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
    for name in [m for m in sys.modules if m.split(".")[0] in
                 ("jax", "jaxlib", "paddle_tpu", "ml_dtypes")]:
        del sys.modules[name]
    sys.modules["jax"] = None          # any import of it now raises
    sys.modules["paddle_tpu"] = None
    sys.modules["ml_dtypes"] = None
    import paddle_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        paddle_tpu_torch.__path__, "paddle_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    leaked = sorted(m for m, mod in sys.modules.items() if mod is not None
                    and m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu",
                                            "ml_dtypes"))
    assert not leaked, leaked
    print(" ".join(names))
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
    # the serving tier's observability, fault, watchdog, router, stream
    # and tools modules, and the checkpoint slice's framework (io,
    # random), fault (retry, checkpoint_manager) and hapi (summary,
    # dynamic_flops) modules, the capture slice's jit (program,
    # traced_layer) and static modules, the deployment slice's
    # quantization, onnx (proto, runtime) and vision.models.small_nets,
    # the distributed slice's groups, collectives, mesh, parallel,
    # launcher and fleet modules, and the vision slice's zoo, transforms,
    # datasets, image backend and ops, the regularizers and the extra
    # optimizers, the SOT capture (jit.sot), and the attribution slice's
    # observability.perf (cost model, device timing, memory census),
    # flight recorder, metrics CLI, profiler and perf_report
    lines = proc.stdout.split()
    assert int(lines[-1]) >= 165
    for name in ("paddle_tpu_torch.quantization", "paddle_tpu_torch.onnx",
                 "paddle_tpu_torch.onnx.proto",
                 "paddle_tpu_torch.onnx.runtime",
                 "paddle_tpu_torch.vision.models.small_nets",
                 "paddle_tpu_torch.distributed.communication.group",
                 "paddle_tpu_torch.distributed.communication.collective",
                 "paddle_tpu_torch.distributed.mesh",
                 "paddle_tpu_torch.distributed.parallel",
                 "paddle_tpu_torch.distributed.launch.main",
                 "paddle_tpu_torch.distributed.launch.__main__",
                 "paddle_tpu_torch.distributed.fleet.fleet_base",
                 "paddle_tpu_torch.distributed.fleet.base.topology",
                 "paddle_tpu_torch.distributed.fleet.base."
                 "distributed_strategy",
                 "paddle_tpu_torch.distributed.fleet.mpu.mp_layers",
                 "paddle_tpu_torch.distributed.fleet.mpu.mp_ops",
                 "paddle_tpu_torch.distributed.fleet.mpu.random",
                 "paddle_tpu_torch.distributed.fleet.meta_parallel."
                 "parallel_wrappers",
                 "paddle_tpu_torch.distributed.fleet.utils."
                 "hybrid_parallel_util",
                 "paddle_tpu_torch.distributed.fleet.meta_optimizers."
                 "hybrid_parallel_optimizer",
                 "paddle_tpu_torch.distributed.fleet.meta_optimizers."
                 "dygraph_sharding_optimizer",
                 "paddle_tpu_torch.regularizer",
                 "paddle_tpu_torch.optimizer.extras",
                 "paddle_tpu_torch.vision.ops",
                 "paddle_tpu_torch.vision.transforms",
                 "paddle_tpu_torch.vision.datasets",
                 "paddle_tpu_torch.vision.image",
                 "paddle_tpu_torch.vision.models.vgg",
                 "paddle_tpu_torch.vision.models.mobilenet",
                 "paddle_tpu_torch.vision.models.densenet",
                 "paddle_tpu_torch.vision.models.inception",
                 "paddle_tpu_torch.vision.models._pretrained",
                 "paddle_tpu_torch.nn.functional.vision",
                 "paddle_tpu_torch.nn.functional.tail",
                 "paddle_tpu_torch.nn.functional._op",
                 "paddle_tpu_torch.nn.layer.rnn",
                 "paddle_tpu_torch.nn.layer.tail",
                 "paddle_tpu_torch.nn.decode",
                 "paddle_tpu_torch.nn.utils",
                 "paddle_tpu_torch.nn.lazy_init",
                 "paddle_tpu_torch.nn.quant",
                 "paddle_tpu_torch.incubate.nn",
                 "paddle_tpu_torch.incubate.nn.layers",
                 "paddle_tpu_torch.incubate.nn.functional",
                 "paddle_tpu_torch.distributed.fleet.moe",
                 "paddle_tpu_torch.ops.control_flow",
                 "paddle_tpu_torch.ops.inplace",
                 "paddle_tpu_torch.ops.tail",
                 "paddle_tpu_torch.fft", "paddle_tpu_torch.signal",
                 "paddle_tpu_torch.geometric",
                 "paddle_tpu_torch.static.nn",
                 "paddle_tpu_torch.static.nn.control_flow",
                 "paddle_tpu_torch.static.program",
                 "paddle_tpu_torch.static.tail",
                 "paddle_tpu_torch.static.nn.common",
                 "paddle_tpu_torch.jit.sot",
                 "paddle_tpu_torch.observability.perf",
                 "paddle_tpu_torch.observability.perf.costmodel",
                 "paddle_tpu_torch.observability.perf.device",
                 "paddle_tpu_torch.observability.perf.memory",
                 "paddle_tpu_torch.observability.flight",
                 "paddle_tpu_torch.observability.__main__",
                 "paddle_tpu_torch.profiler",
                 "paddle_tpu_torch.tools.perf_report"):
        assert name in lines, name


_LAUNCH_NO_JAX = textwrap.dedent("""
    import runpy, sys
    sys.modules["jax"] = None
    sys.modules["paddle_tpu"] = None
    sys.argv = ["launch"] + sys.argv[1:]
    runpy.run_module("paddle_tpu_torch.distributed.launch",
                     run_name="__main__")
""")


def test_the_launcher_runs_without_jax(tmp_path):
    """``python -m paddle_tpu_torch.distributed.launch`` with jax and
    paddle_tpu unimportable: two ranks of a script that checks its
    environment, and neither of them imports jax either."""
    script = tmp_path / "rank.py"
    script.write_text(textwrap.dedent("""
        import os, sys
        sys.modules["jax"] = None
        sys.modules["paddle_tpu"] = None
        import paddle_tpu_torch.distributed as dist
        assert dist.get_world_size() == 2, os.environ["WORLD_SIZE"]
        assert os.environ["PADDLE_TRAINER_ID"] == os.environ["RANK"]
        print("rank", dist.get_rank(), "of", dist.get_world_size())
    """))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _LAUNCH_NO_JAX, "--nproc_per_node", "2",
         "--master", "127.0.0.1:29123", str(script)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert sorted(proc.stdout.split("\n")[:2]) == ["rank 0 of 2",
                                                   "rank 1 of 2"]


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


def test_vision_entry_points_raise_without_cuda():
    """The vision slice's entry points take the card unless the caller
    set the CPU: a zoo model, a vision op on host data and ``to_tensor``
    outside a loader worker raise without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real")
    from paddle_tpu_torch.vision import models, ops, transforms
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        models.mobilenet_v2(num_classes=10)
    boxes = np.array([[0, 0, 4, 4], [1, 1, 5, 5]], np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops.nms(boxes, 0.5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        transforms.to_tensor(np.zeros((4, 4, 3), np.uint8))
    with paddle_tpu_torch.device_guard("cpu"):
        assert ops.nms(boxes, 0.5).numpy().tolist() == [0, 1]


def test_nn_entry_points_raise_without_cuda():
    """The nn slice's layers, caches and functionals on host data take
    the card unless the caller set the CPU; under the CPU guard the
    caches, ``one_hot`` and ``sequence_mask`` land on their inputs'
    device."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real")
    nn, F = paddle_tpu_torch.nn, paddle_tpu_torch.nn.functional
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nn.Transformer(d_model=8, nhead=2, num_encoder_layers=1,
                       num_decoder_layers=1, dim_feedforward=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nn.LSTM(4, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        F.one_hot(np.array([1, 2]), 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        F.sequence_mask(np.array([1, 2]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nn.Transformer.generate_square_subsequent_mask(4)
    with paddle_tpu_torch.device_guard("cpu"):
        mha = nn.MultiHeadAttention(8, 2)
        mem = paddle_tpu_torch.to_tensor(np.zeros((1, 3, 8), np.float32))
        cache = mha.gen_cache(mem)
        assert cache.k._data.device.type == "cpu"
        assert F.one_hot(np.array([1, 2]), 4)._data.device.type == "cpu"


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


def test_paddle_api_needs_cuda_or_set_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real")
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    assert paddle_tpu_torch.get_device() == "gpu:0"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paddle_tpu_torch.to_tensor([1.0, 2.0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paddle_tpu_torch.nn.Linear(4, 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BertForPretraining(BertConfig(vocab_size=64, hidden_size=32,
                                      num_hidden_layers=1,
                                      num_attention_heads=2,
                                      intermediate_size=64))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paddle_tpu_torch.set_device("gpu")
    assert paddle_tpu_torch.get_device() == "gpu:0"


def test_cpu_paddle_api_bert_step_launches_nothing():
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    with paddle_tpu_torch.device_guard("cpu"):
        model = BertForPretraining(BertConfig(
            vocab_size=64, hidden_size=128, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=64,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            fused_loss=True))
        opt = paddle_tpu_torch.optimizer.AdamW(
            parameters=model.parameters())
        ids = paddle_tpu_torch.to_tensor(np.zeros((2, 8), np.int64))
        model(ids, masked_lm_labels=ids)[2].backward()
        opt.step()
    assert all(p._data.device.type == "cpu" for p in model.parameters())
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches) == (0, 0, 0)


def test_a_saved_program_needs_cuda_or_set_device_cpu(tmp_path):
    """``jit.load`` moves the program and its state to the current device,
    so without a card an artifact refuses to load (and the predictor to
    start) unless the caller asked for the CPU; under
    ``set_device("cpu")`` it runs there and launches nothing. (An
    artifact exported on the card, loaded on the CPU:
    ``test_torch_cuda_kernels.py::test_translated_layer_launches_k1``.)"""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real")
    from paddle_tpu_torch.static import InputSpec
    with paddle_tpu_torch.device_guard("cpu"):
        net = paddle_tpu_torch.nn.Linear(8, 4)
        path = str(tmp_path / "lin")
        paddle_tpu_torch.jit.save(net, path, input_spec=[InputSpec([-1, 8])])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paddle_tpu_torch.jit.load(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paddle_tpu_torch.inference.create_predictor(
            paddle_tpu_torch.inference.Config(path))
    with paddle_tpu_torch.device_guard("cpu"):
        loaded = paddle_tpu_torch.jit.load(path)
        x = np.ones((3, 8), np.float32)
        out = loaded(paddle_tpu_torch.to_tensor(x))
        assert out._data.device.type == "cpu"
        np.testing.assert_allclose(out.numpy(),
                                   net(paddle_tpu_torch.to_tensor(x)).numpy(),
                                   atol=1e-6)
    assert fa.flash_attention_fwd.launches == 0


def test_op_library_entry_points_need_cuda_or_set_device_cpu():
    """The creation entry points of the op library's last slice land on
    the card by default and raise without CUDA; on the CPU they make CPU
    tensors."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real")
    import paddle_tpu_torch as paddle
    makers = (lambda: paddle.fft.fftfreq(8), lambda: paddle.logspace(0, 2, 5),
              lambda: paddle.tril_indices(4, 4),
              lambda: paddle.log_normal(shape=[3]))
    for make in makers:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    with paddle.device_guard("cpu"):
        for make in makers:
            assert make()._data.device.type == "cpu"


def test_a_static_program_runs_on_the_card_unless_asked_for_the_cpu():
    """``static.data`` makes its placeholder on the current device, so a
    program cannot be built without CUDA unless the caller asked for the
    CPU; a program built under ``set_device("cpu")`` runs there, and
    ``Executor.run`` without it (or on a ``CUDAPlace``) raises where CUDA
    is absent: nothing moves to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real")
    static = paddle_tpu_torch.static
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        with static.program_guard(static.Program()):
            static.data("x", [2, 4], "float32")
    main = static.Program()
    with paddle_tpu_torch.device_guard("cpu"):
        with static.program_guard(main):
            x = static.data("x", [None, 4], "float32")
            y = static.nn.fc(x, 3)
        feed = {"x": np.ones((2, 4), np.float32)}
        (out,) = static.Executor().run(main, feed, [y])
        (t,) = static.Executor(paddle_tpu_torch.CPUPlace()).run(
            main, feed, [y], return_numpy=False)
    assert out.shape == (2, 3) and t._data.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        static.Executor().run(main, feed, [y])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        static.Executor(paddle_tpu_torch.CUDAPlace(0)).run(main, feed, [y])
    assert fa.flash_attention_fwd.launches == 0
