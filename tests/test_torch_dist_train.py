"""The port's TestDistBase: N processes train to the losses of one.

The JAX package's tiny GPT (vocab 128, hidden 32, 2 layers, 2 heads,
S 16) trains 6 AdamW steps in-process on one fixed global batch of 8, as
``tests/dist_train_worker.py single`` does; its initial weights go to
the port's ranks as numpy arrays. The port trains the same model from
them through ``fleet.init`` -> ``fleet.distributed_model`` ->
``fleet.distributed_optimizer`` on gloo (``tests/torch_dist_worker.py``),
each rank on its rows of the batch: ``dp`` (2 ranks, DataParallel's
reducer), ``dp_mp`` (2: tensor parallel), ``dp_sharding`` (2: ZeRO-1)
and dp2 x mp2 (4), the first two with ``ClipGradByGlobalNorm(1.0)``
(the mp-aware and the sharding-aware global norm). The mean loss over
the ranks must equal the JAX losses within rtol = atol = 2e-4 (the JAX
harness's own bound, ``tests/test_multiproc_train.py``), and the ranks
that share a data shard must agree to 1e-6. A rank that exits 3 makes
the launch exit 3 and its peers are ended.
"""
import os

import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu.models import GPTConfig, GPTForCausalLM
from torch_dist_harness import launch, logs, losses

STEPS = 6


def _jax_run(clip):
    """(initial arrays, losses) of the JAX single-process run."""
    jpaddle.seed(1234)
    model = GPTForCausalLM(GPTConfig(vocab_size=128, hidden_size=32,
                                     num_layers=2, num_heads=2,
                                     max_seq_len=16,
                                     use_flash_attention=False))
    arrays = {f"gpt/{k}": v.numpy() for k, v in model.state_dict().items()}
    batch = np.random.RandomState(0).randint(0, 128, (8, 16)).astype(
        np.int64)
    opt = jpaddle.optimizer.AdamW(
        learning_rate=1e-2, parameters=model.parameters(),
        grad_clip=jpaddle.nn.ClipGradByGlobalNorm(1.0) if clip else None)
    out = []
    for _ in range(STEPS):
        ids = jpaddle.to_tensor(batch)
        _, loss = model(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        out.append(float(loss.numpy()))
    return {**arrays, "batch": batch}, out


@pytest.fixture(scope="module")
def baselines():
    return {clip: _jax_run(clip) for clip in (False, True)}


@pytest.mark.parametrize("strategy,nproc,clip", [
    ("dp", 2, False), ("dp_mp", 2, True), ("dp_sharding", 2, True),
    ("dp2_mp2", 4, False)])
def test_losses_match_the_jax_single_process_run(baselines, tmp_path,
                                                 strategy, nproc, clip):
    inputs, want = baselines[clip]
    assert want[-1] < want[0] - 0.5, f"the baseline did not train: {want}"
    job = f"train:{strategy}" + (":clip" if clip else "")
    proc = launch(job, nproc, inputs, str(tmp_path))
    assert proc.returncode == 0, proc.stderr + logs(str(tmp_path))
    ranks = losses(str(tmp_path), nproc)
    mean = np.mean([r["losses"] for r in ranks], axis=0)
    np.testing.assert_allclose(mean, want, rtol=2e-4, atol=2e-4,
                               err_msg=f"{strategy} diverged from the JAX "
                                       f"single-process run")
    by_shard = {}
    for r in ranks:
        by_shard.setdefault(r["data_shard"], []).append(r["losses"])
    assert len(by_shard) == ranks[0]["shards"]
    for same in by_shard.values():
        for other in same[1:]:
            np.testing.assert_allclose(other, same[0], rtol=1e-6, atol=1e-6)
    if strategy == "dp":
        assert ranks[0]["buckets"] >= 1


def test_a_failed_rank_fails_the_launch(tmp_path):
    proc = launch("fail", 2, {"unused": np.zeros(1)}, str(tmp_path),
                  abort_grace=1.0, timeout=120)
    assert proc.returncode == 3, proc.stderr + logs(str(tmp_path))
    assert "rank 1 ended with 3" in proc.stderr
    pid = int(open(os.path.join(tmp_path, "pid.r0")).read())
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)
    assert not os.path.exists(os.path.join(tmp_path, "finished.r0"))
