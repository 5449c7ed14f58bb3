"""The port's tensor-parallel layers against the JAX package's fleet
layers.

A 2-process gloo cluster through the port's launcher
(``tests/torch_dist_worker.py tp``, ``fleet.init`` with mp_degree 2)
runs the four mp layers forward and backward, each rank with its shard
of the same full weights, and a tensor-parallel tiny GPT loaded from the
JAX model's arrays by the carry function's per-rank split. The JAX
package runs the fleet layers on a 2-device ``mp`` mesh with the full
weights (its layers hold the global arrays) and the GPT on one device.
Rank r must hold shard r of every JAX output and gradient that is split
over mp, and the whole of every replicated one (fp32, 1e-5). The same
cluster runs ``DataParallel``'s reducer on a Paddle-API ``Layer``, each
rank on its rows, against the JAX ``DataParallel`` on the global batch.
In-process:
the q/k/v head-group split, ids outside a vocab shard, and
``ParallelCrossEntropy`` against ``F.cross_entropy`` on gathered logits.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu_torch.distributed.fleet.mpu import mp_layers
from paddle_tpu_torch.nn import functional as F
from torch_dist_harness import launch, logs, outputs

N = 2
TOL = dict(rtol=1e-5, atol=1e-5)
B, S, HIN, HOUT, V = 2, 5, 8, 12, 16


def _inputs():
    rng = np.random.RandomState(3)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    d = {"x": f(B, S, HIN), "col_w": f(HIN, HOUT), "col_b": f(HOUT),
         "col_dy": f(B, S, HOUT), "row_x": f(B, S, HOUT),
         "row_w": f(HOUT, HIN), "row_b": f(HIN), "row_dy": f(B, S, HIN),
         "emb_w": f(V, HIN), "ids": rng.randint(0, V, (B, S)),
         "emb_dy": f(B, S, HIN), "logits": f(B, S, V),
         "labels": rng.randint(0, V, (B, S)),
         "gpt_ids": rng.randint(0, 128, (2, 16)),
         "dp_x": f(4, HIN), "dp_w": f(HIN, 3), "dp_b": f(3)}
    return d


def _jax_gpt():
    jpaddle.seed(11)
    return JGPT(JGPTConfig(vocab_size=128, hidden_size=32, num_layers=2,
                           num_heads=2, max_seq_len=16,
                           use_flash_attention=False))


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    d = _inputs()
    gpt = _jax_gpt()
    arrays = {f"gpt/{k}": v.numpy() for k, v in gpt.state_dict().items()}
    out = tmp_path_factory.mktemp("tp")
    proc = launch("tp", N, {**d, **arrays}, str(out))
    assert proc.returncode == 0, proc.stderr + logs(str(out))
    return d, gpt, outputs(str(out), "tp", N)


@pytest.fixture(scope="module")
def jax_mp_mesh():
    old = jmesh._global_mesh
    jmesh.set_mesh(jmesh.build_mesh({"mp": N}, devices=jax.devices()[:N]))
    yield
    jmesh._global_mesh = old


def _cols(a, r, n=N):
    c = a.shape[-1] // n
    return a[..., r * c:(r + 1) * c]


def _rows(a, r, n=N):
    c = a.shape[0] // n
    return a[r * c:(r + 1) * c]


def _jax_run(layer, x, dy, w, b=None):
    layer.weight.set_value(w)
    if b is not None:
        layer.bias.set_value(b)
    xt = jpaddle.to_tensor(x, stop_gradient=False)
    y = layer(xt)
    (y * jpaddle.to_tensor(dy)).sum().backward()
    return (y.numpy(), xt.grad.numpy(), layer.weight.grad.numpy(),
            None if b is None else layer.bias.grad.numpy())


@pytest.mark.parametrize("gather", [True, False])
def test_column_parallel_linear(cluster, jax_mp_mesh, gather):
    d, _, got = cluster
    layer = jfleet.ColumnParallelLinear(HIN, HOUT, has_bias=True,
                                        gather_output=gather)
    y, dx, dw, db = _jax_run(layer, d["x"], d["col_dy"], d["col_w"],
                             d["col_b"])
    for r in range(N):
        o = {k.split(".", 2)[-1]: v for k, v in got[r].items()
             if k.startswith(f"col.gather{int(gather)}.")}
        np.testing.assert_allclose(o["y"], y if gather else _cols(y, r),
                                   **TOL)
        np.testing.assert_allclose(o["dx"], dx, **TOL)
        np.testing.assert_allclose(o["dw"], _cols(dw, r), **TOL)
        np.testing.assert_allclose(o["db"], _cols(db, r), **TOL)
        if gather:
            np.testing.assert_allclose(got[r]["torch_col.y"], y, **TOL)


@pytest.mark.parametrize("parallel", [False, True])
def test_row_parallel_linear(cluster, jax_mp_mesh, parallel):
    d, _, got = cluster
    layer = jfleet.RowParallelLinear(HOUT, HIN, has_bias=True,
                                     input_is_parallel=parallel)
    y, dx, dw, db = _jax_run(layer, d["row_x"], d["row_dy"], d["row_w"],
                             d["row_b"])
    for r in range(N):
        o = {k.split(".", 2)[-1]: v for k, v in got[r].items()
             if k.startswith(f"row.parallel{int(parallel)}.")}
        np.testing.assert_allclose(o["y"], y, **TOL)
        np.testing.assert_allclose(o["dx"], _cols(dx, r) if parallel else dx,
                                   **TOL)
        np.testing.assert_allclose(o["dw"], _rows(dw, r), **TOL)
        np.testing.assert_allclose(o["db"], db, **TOL)
        np.testing.assert_allclose(got[r]["torch_row.y"], y, **TOL)


def test_vocab_parallel_embedding(cluster, jax_mp_mesh):
    d, _, got = cluster
    assert (d["ids"] < V // 2).any() and (d["ids"] >= V // 2).any()
    layer = jfleet.VocabParallelEmbedding(V, HIN)
    layer.weight.set_value(d["emb_w"])
    y = layer(jpaddle.to_tensor(d["ids"]))
    (y * jpaddle.to_tensor(d["emb_dy"])).sum().backward()
    for r in range(N):
        np.testing.assert_allclose(got[r]["emb.y"], y.numpy(), **TOL)
        np.testing.assert_allclose(got[r]["emb.dw"],
                                   _rows(layer.weight.grad.numpy(), r), **TOL)


def test_parallel_cross_entropy(cluster, jax_mp_mesh):
    """Per-token loss (..., 1) and the logits' gradient of its mean,
    against the JAX layer on the full logits; the loss against the
    port's F.cross_entropy on the gathered logits."""
    d, _, got = cluster
    lt = jpaddle.to_tensor(d["logits"], stop_gradient=False)
    loss = jfleet.ParallelCrossEntropy()(lt, jpaddle.to_tensor(d["labels"]))
    loss.mean().backward()
    plain = F.cross_entropy(torch.from_numpy(d["logits"]),
                            torch.from_numpy(d["labels"]), reduction="none")
    for r in range(N):
        assert got[r]["pce.loss"].shape == (B, S, 1)
        np.testing.assert_allclose(got[r]["pce.loss"], loss.numpy(), **TOL)
        np.testing.assert_allclose(got[r]["pce.loss"][..., 0], plain.numpy(),
                                   **TOL)
        np.testing.assert_allclose(got[r]["pce.dlogits"],
                                   _cols(lt.grad.numpy(), r), **TOL)


def _head_groups(a, r, n=N):
    """Rank r's q, k and v columns (last dim) of a fused (..., 3h)."""
    return np.concatenate([_cols(p, r, n) for p in np.split(a, 3, -1)], -1)


def test_tensor_parallel_gpt(cluster):
    """The TP GPT from the JAX model's arrays: the gathered logits and the
    loss equal the JAX model's; each rank's qkv_proj weight is the q, k
    and v columns of its heads (torch layout), and the gradients of the
    split parameters are the JAX gradients' shards."""
    d, gpt, got = cluster
    ids = jpaddle.to_tensor(d["gpt_ids"])
    logits = gpt(ids).numpy()
    _, loss = gpt(ids, labels=ids)
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in gpt.named_parameters()}
    sd = {k: v.numpy() for k, v in gpt.state_dict().items()}
    qkv = "gpt.blocks.0.attn.qkv_proj.weight"
    for r in range(N):
        g = got[r]
        np.testing.assert_allclose(g["gpt.logits"], logits, **TOL)
        np.testing.assert_allclose(g["gpt.local_logits"], _cols(logits, r),
                                   **TOL)
        np.testing.assert_allclose(g["gpt.loss"], loss.numpy(), **TOL)
        np.testing.assert_array_equal(g["gpt.qkv_w"],
                                      _head_groups(sd[qkv], r).T)
        np.testing.assert_allclose(g["gpt.qkv_dw"],
                                   _head_groups(grads[qkv], r).T, **TOL)
        np.testing.assert_allclose(g["gpt.wte_dw"],
                                   _rows(grads["gpt.wte.weight"], r), **TOL)
        np.testing.assert_allclose(g["gpt.ln_f_dw"],
                                   grads["gpt.ln_f.weight"], **TOL)


def test_qkv_head_group_split():
    """``shard(.., groups=3)``: rank r of n takes rows [r h/n, (r+1) h/n)
    of each of the q, k and v thirds, in that order (a contiguous cut
    would mix q, k and v across ranks)."""
    h, n = 8, 2
    full = np.arange(3 * h * 3, dtype=np.float32).reshape(3 * h, 3)
    for r in range(n):
        want = np.concatenate([full[t * h + r * h // n:t * h + (r + 1) * h // n]
                               for t in range(3)])
        np.testing.assert_array_equal(mp_layers.shard(full, 0, r, n, 3),
                                      want)
        np.testing.assert_array_equal(
            mp_layers.shard(torch.from_numpy(full), 0, r, n, 3).numpy(), want)
    np.testing.assert_array_equal(mp_layers.shard(full, 1, 1, 3),
                                  full[:, 1:2])


def test_ids_outside_the_shard_give_zero_rows():
    """Rank 1 of 2 holds rows [8, 16): before the sum over mp an id below
    8 gives a zero row and no gradient."""
    w = torch.randn(8, 4, requires_grad=True)
    ids = torch.tensor([[0, 7, 8, 15], [3, 9, 12, 1]])
    out = mp_layers.vocab_parallel_embedding(ids, w, start=8)
    inside = ids >= 8
    assert torch.equal(out[~inside], torch.zeros_like(out[~inside]))
    assert torch.equal(out[inside], w[ids[inside] - 8])
    out.sum().backward()
    assert torch.equal(w.grad.sum(1) != 0,
                       torch.isin(torch.arange(8), ids[inside] - 8))


def test_parallel_cross_entropy_one_rank_is_cross_entropy():
    """With no mp group the vocab-parallel loss is the plain one, and so
    is its gradient."""
    rng = np.random.RandomState(4)
    logits = torch.from_numpy(rng.randn(6, 10).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 10, 6))
    labels[2] = -100
    a = logits.clone().requires_grad_()
    b = logits.clone().requires_grad_()
    got = mp_layers.parallel_cross_entropy(a, labels)
    want = F.cross_entropy(b, labels, reduction="none")
    torch.testing.assert_close(got, want)
    got.sum().backward()
    want.sum().backward()
    torch.testing.assert_close(a.grad, b.grad)


def test_data_parallel_reducer(cluster):
    """Each rank's rows through the port's DataParallel give the JAX
    DataParallel's gradients of the global batch's mean loss (a 2-device
    dp mesh); an unused parameter gets a zero gradient with
    find_unused_parameters and raises without it; no_sync keeps the
    rank's own gradient, and the next synchronised backward reduces what
    accumulated (twice the global gradient here); at a tiny
    comm_buffer_size every parameter is a bucket of its own; after a
    backward that raised partway, the next one still averages."""
    from paddle_tpu.distributed.parallel import DataParallel as JDP
    d, _, got = cluster
    old = jmesh._global_mesh
    try:
        jmesh.set_mesh(jmesh.build_mesh({"dp": N},
                                         devices=jax.devices()[:N]))
        lin = jpaddle.nn.Linear(HIN, 3)
        lin.weight.set_value(d["dp_w"])
        lin.bias.set_value(d["dp_b"])
        (JDP(lin)(jpaddle.to_tensor(d["dp_x"])) ** 2).mean().backward()
    finally:
        jmesh._global_mesh = old
    dw, db = lin.weight.grad.numpy(), lin.bias.grad.numpy()
    rows = d["dp_x"].shape[0] // N
    for r in range(N):
        g = got[r]
        np.testing.assert_allclose(g["dp.dw"], dw, **TOL)
        np.testing.assert_allclose(g["dp.db"], db, **TOL)
        np.testing.assert_array_equal(g["dp.unused_dw"], 0.0)
        assert int(g["dp.buckets"]) == 4
        assert int(g["dp.default_buckets"]) == 1
        assert bool(g["dp.unused_raised"])
        x = d["dp_x"][r * rows:(r + 1) * rows]
        y = x @ d["dp_w"] + d["dp_b"]
        np.testing.assert_allclose(g["dp.local_dw"], x.T @ (2 * y) / y.size,
                                   **TOL)
        np.testing.assert_allclose(g["dp.accumulated_dw"], 2 * dw, **TOL)
        assert bool(g["dp.aborted_raised"])
        np.testing.assert_allclose(g["dp.after_abort_dw"], dw, **TOL)
        np.testing.assert_allclose(g["dp.after_abort_db"], db, **TOL)
