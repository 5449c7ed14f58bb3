"""A rank of the port's multi-process tests (not collected: no test_
prefix). Run by the port's launcher, one process a rank, on the CPU over
gloo; it imports torch, numpy and the port only:

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node N \\
        --master 127.0.0.1:PORT tests/torch_dist_worker.py JOB IN OUT

JOB is ``collectives`` (4 ranks: every collective on the world and on
each axis group of a dp2 x mp2 mesh), ``exit`` / ``exit:destroy`` (one
all-reduce on the world and on a dp2 x mp2 mesh's groups, then return,
leaving the teardown to the exit hook or calling
``destroy_process_group`` first; writes the threads alive after the
exit hook), ``tp`` (2 ranks: the mp layers and
a tensor-parallel GPT), ``train:<strategy>[:clip]`` (the TestDistBase
parity run: 6 AdamW steps of the tiny GPT from the JAX model's weights)
or ``fail`` (rank 1 exits 3 while the others wait in a collective). IN
is an ``.npz`` of the inputs; each rank writes ``OUT/<job>.r<rank>.npz``
(and ``.json`` for the training losses).
"""
import json
import os
import sys

import numpy as np
import torch

import paddle_tpu_torch as paddle
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed import fleet

JOB, IN, OUT = sys.argv[1], sys.argv[2], sys.argv[3]
paddle.set_device("cpu")


def save(tag, rank, **arrays):
    np.savez(os.path.join(OUT, f"{tag}.r{rank}.npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})


def collectives():
    dist.init_parallel_env()
    rank = dist.get_rank()
    x = np.load(IN)["x"]
    mesh = dist.set_mesh(dist.build_mesh({"dp": 2, "mp": 2}))
    groups = {"world": dist.get_default_group(),
              "dp": dist.new_group(axes=("dp",)),
              "mp": dist.new_group(axes="mp")}
    out = {}
    for gname, g in groups.items():
        n, i = g.nranks, g.rank
        mine = torch.from_numpy(x[rank].copy())
        for op in ("sum", "max", "min", "prod", "avg"):
            t = mine.clone()
            dist.all_reduce(t, op=op, group=g)
            out[f"{gname}.all_reduce.{op}"] = t
        parts = []
        dist.all_gather(parts, mine, group=g)
        out[f"{gname}.all_gather"] = torch.stack(parts)
        for op in ("sum", "max", "avg"):
            t = torch.empty((mine.shape[0] // n,) + mine.shape[1:])
            dist.reduce_scatter(t, mine.clone(), op=op, group=g)
            out[f"{gname}.reduce_scatter.{op}"] = t
        listed = dist.reduce_scatter(None, list(mine.chunk(n, 0)), group=g)
        out[f"{gname}.reduce_scatter.list"] = listed
        t = mine.clone()
        dist.broadcast(t, src=g.ranks[n - 1], group=g)
        out[f"{gname}.broadcast"] = t
        t = mine.clone()
        dist.reduce(t, dst=g.ranks[0], group=g)
        if i == 0:
            out[f"{gname}.reduce"] = t
        t = torch.empty((mine.shape[0] // n,) + mine.shape[1:])
        dist.scatter(t, list(mine.chunk(n, 0)) if i == 0 else None,
                     src=g.ranks[0], group=g)
        out[f"{gname}.scatter"] = t
        outs = []
        dist.alltoall(outs, list(mine.chunk(n, 0)), group=g)
        out[f"{gname}.alltoall"] = torch.cat(outs)
        out[f"{gname}.alltoall_single"] = dist.alltoall_single(
            None, mine.clone(), group=g)
        objs = []
        dist.all_gather_object(objs, {"rank": rank, "group_rank": i}, group=g)
        out[f"{gname}.all_gather_object"] = np.array(
            [[o["rank"], o["group_rank"]] for o in objs])
        objs = [None, rank] if i == 0 else [rank, None]
        dist.broadcast_object_list(objs, src=g.ranks[0], group=g)
        out[f"{gname}.broadcast_object_list"] = np.array(
            [-1 if o is None else o for o in objs])
        # the ring: rank i of the group sends to i + 1 and receives from i - 1
        got = torch.empty_like(mine)
        tasks = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, mine, g.ranks[(i + 1) % n], g),
            dist.P2POp(dist.irecv, got, g.ranks[(i - 1) % n], g)])
        for task in tasks:
            task.wait()
        out[f"{gname}.ring"] = got
        if gname != "world":
            out[f"{gname}.shift"] = dist.shift_along_axis(mine, gname, 1,
                                                          mesh)
        dist.barrier(g)
    # send/recv pairs over the mp groups: mp coordinate 0 sends, 1 receives
    g = groups["mp"]
    if g.rank == 0:
        dist.send(torch.from_numpy(x[rank].copy()), dst=g.ranks[1], group=g)
    else:
        t = torch.empty(x[rank].shape)
        dist.recv(t, src=g.ranks[0], group=g)
        out["mp.send_recv"] = t
    # sync_op=False returns a task; a Paddle Tensor is written in place
    t = paddle.to_tensor(x[rank].copy())
    task = dist.all_reduce(t, group=groups["dp"], sync_op=False)
    task.wait()
    out["dp.all_reduce.task_paddle"] = t.numpy()
    perf = fleet.collective_perf("allreduce", round_num=2,
                                 size_and_time={4096: None, 65536: None})
    out["perf.sizes"] = np.array(sorted(perf))
    # what is refused
    errors = []
    for what, call in (
            ("src outside", lambda: dist.broadcast(
                torch.zeros(2), src=[r for r in range(4)
                                     if r not in groups["mp"].ranks][0],
                group=groups["mp"])),
            ("bad op", lambda: dist.all_reduce(torch.zeros(2), op="mean")),
            ("uneven", lambda: dist.reduce_scatter(None, torch.zeros(3),
                                                   group=groups["world"]))):
        try:
            call()
            errors.append(f"{what}: no error")
        except ValueError:
            pass
    other = dist.new_group([0, 1])
    if rank >= 2:
        try:
            dist.all_reduce(torch.zeros(2), group=other)
            errors.append("non-member: no error")
        except ValueError:
            pass
    assert not errors, errors
    save("collectives", rank, **{k: (v.numpy() if isinstance(
        v, torch.Tensor) else v) for k, v in out.items()})


def tp():
    from paddle_tpu_torch.distributed.fleet.mpu import mp_layers
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.models.convert import load_jax_state
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 2}
    fleet.init(is_collective=True, strategy=strategy)
    rank = dist.get_rank()
    d = dict(np.load(IN))
    out = {}

    def run(name, layer, x, dy, weights):
        layer.weight.set_value(weights[0])
        if len(weights) > 1:
            layer.bias.set_value(weights[1])
        xt = paddle.to_tensor(x, stop_gradient=False)
        y = layer(xt)
        (y * paddle.to_tensor(dy)).sum().backward()
        out[f"{name}.y"] = y.numpy()
        out[f"{name}.dx"] = xt.grad.numpy()
        out[f"{name}.dw"] = layer.weight.grad.numpy()
        if len(weights) > 1:
            out[f"{name}.db"] = layer.bias.grad.numpy()

    r, n = rank, 2
    w_col, b_col = d["col_w"], d["col_b"]
    cut = w_col.shape[1] // n
    for gather in (True, False):
        layer = fleet.ColumnParallelLinear(*w_col.shape, has_bias=True,
                                           gather_output=gather)
        dy = d["col_dy"] if gather else d["col_dy"][..., r * cut:(r + 1) * cut]
        run(f"col.gather{int(gather)}", layer, d["x"], dy,
            [w_col[:, r * cut:(r + 1) * cut], b_col[r * cut:(r + 1) * cut]])
    w_row, b_row = d["row_w"], d["row_b"]
    rc = w_row.shape[0] // n
    for parallel in (False, True):
        layer = fleet.RowParallelLinear(*w_row.shape, has_bias=True,
                                        input_is_parallel=parallel)
        x = d["row_x"][..., r * rc:(r + 1) * rc] if parallel else d["row_x"]
        run(f"row.parallel{int(parallel)}", layer, x, d["row_dy"],
            [w_row[r * rc:(r + 1) * rc], b_row])
    emb = fleet.VocabParallelEmbedding(*d["emb_w"].shape)
    vc = d["emb_w"].shape[0] // n
    emb.weight.set_value(d["emb_w"][r * vc:(r + 1) * vc])
    y = emb(paddle.to_tensor(d["ids"]))
    (y * paddle.to_tensor(d["emb_dy"])).sum().backward()
    out["emb.y"] = y.numpy()
    out["emb.dw"] = emb.weight.grad.numpy()
    # ParallelCrossEntropy on this rank's vocab shard of the logits
    logits = d["logits"]
    lc = logits.shape[-1] // n
    lt = paddle.to_tensor(logits[..., r * lc:(r + 1) * lc],
                          stop_gradient=False)
    loss = fleet.ParallelCrossEntropy()(lt, paddle.to_tensor(d["labels"]))
    loss.mean().backward()
    out["pce.loss"] = loss.numpy()
    out["pce.dlogits"] = lt.grad.numpy()
    # the torch-level twins against the Paddle-API layers' outputs
    col = mp_layers.TorchColumnParallelLinear(*w_col.shape,
                                              gather_output=True)
    col.load_full("weight", torch.from_numpy(w_col.T.copy()))
    col.load_full("bias", torch.from_numpy(b_col))
    out["torch_col.y"] = col(torch.from_numpy(d["x"])).detach().numpy()
    row = mp_layers.TorchRowParallelLinear(*w_row.shape)
    row.load_full("weight", torch.from_numpy(w_row.T.copy()))
    with torch.no_grad():
        row.bias.copy_(torch.from_numpy(b_row))
    out["torch_row.y"] = row(torch.from_numpy(d["row_x"])).detach().numpy()
    # a tensor-parallel GPT from the JAX model's arrays
    cfg = GPTConfig(vocab_size=128, hidden_size=32, num_layers=2,
                    num_heads=2, max_seq_len=16, mp_degree=2)
    model = GPTForCausalLM(cfg, device="cpu")
    arrays = {k[len("gpt/"):]: v for k, v in d.items()
              if k.startswith("gpt/")}
    load_jax_state(model, arrays, mp_rank=r, mp_degree=n)
    ids = torch.from_numpy(d["gpt_ids"])
    out["gpt.logits"] = model(ids).detach().numpy()
    local, loss = model(ids, labels=ids)
    loss.backward()
    out["gpt.local_logits"] = local.detach().numpy()
    out["gpt.loss"] = loss.detach().numpy()
    out["gpt.qkv_w"] = model.gpt.blocks[0].attn.qkv_proj.weight.detach()\
        .numpy()
    out["gpt.qkv_dw"] = model.gpt.blocks[0].attn.qkv_proj.weight.grad\
        .numpy()
    out["gpt.wte_dw"] = model.gpt.wte.weight.grad.numpy()
    out["gpt.ln_f_dw"] = model.gpt.ln_f.weight.grad.numpy()
    out.update(data_parallel(d, r))
    save("tp", rank, **out)


def data_parallel(d, r):
    """DataParallel's reducer on a Paddle-API Layer over the world (each
    rank its rows of dp_x): the averaged gradients, an unused parameter
    with find_unused_parameters, no_sync's local gradients and the next
    backward's reduction of what they accumulated, one bucket a
    parameter at a tiny comm_buffer_size, the raise without
    find_unused_parameters, and a backward that raises after the
    reducer's first hook (its buckets launched) followed by one that
    averages."""
    from paddle_tpu_torch import nn

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(*d["dp_w"].shape)
            self.unused = nn.Linear(3, 3)
            self.fc.weight.set_value(d["dp_w"])
            self.fc.bias.set_value(d["dp_b"])

        def forward(self, x):
            return self.fc(x)

    rows = d["dp_x"].shape[0] // 2
    x = paddle.to_tensor(d["dp_x"][r * rows:(r + 1) * rows])
    out = {}
    net = Net()
    model = dist.DataParallel(net, comm_buffer_size=1e-6,
                              last_comm_buffer_size=1e-6,
                              find_unused_parameters=True,
                              group=dist.get_default_group())
    (model(x) ** 2).mean().backward()
    out["dp.dw"] = net.fc.weight.grad.numpy()
    out["dp.db"] = net.fc.bias.grad.numpy()
    out["dp.unused_dw"] = net.unused.weight.grad.numpy()
    out["dp.buckets"] = np.array(model.bucket_count)
    net.clear_gradients()
    with model.no_sync():
        (model(x) ** 2).mean().backward()
    out["dp.local_dw"] = net.fc.weight.grad.numpy()
    (model(x) ** 2).mean().backward()
    out["dp.accumulated_dw"] = net.fc.weight.grad.numpy()
    strict = Net()
    strict_model = dist.DataParallel(strict, group=dist.get_default_group())
    try:
        (strict_model(x) ** 2).mean().backward()
        out["dp.unused_raised"] = np.array(False)
    except RuntimeError as e:
        out["dp.unused_raised"] = np.array(
            "find_unused_parameters" in str(e))
    out["dp.default_buckets"] = np.array(strict_model.bucket_count)

    def boom(p):
        raise RuntimeError("boom")
    lin = nn.Linear(*d["dp_w"].shape)
    lin.weight.set_value(d["dp_w"])
    lin.bias.set_value(d["dp_b"])
    lin_model = dist.DataParallel(lin, comm_buffer_size=1e-6,
                                  last_comm_buffer_size=1e-6,
                                  group=dist.get_default_group())
    hook = lin.bias._data.register_post_accumulate_grad_hook(boom)
    try:
        (lin_model(x) ** 2).mean().backward()
        out["dp.aborted_raised"] = np.array(False)
    except RuntimeError as e:
        out["dp.aborted_raised"] = np.array("boom" in str(e))
    hook.remove()
    lin.clear_gradients()
    (lin_model(x) ** 2).mean().backward()
    out["dp.after_abort_dw"] = lin.weight.grad.numpy()
    out["dp.after_abort_db"] = lin.bias.grad.numpy()
    return out


def train(strategy_name, clip):
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.models.convert import load_jax_state
    degrees = {"dp": {}, "dp_mp": {"mp_degree": 2},
               "dp_sharding": {"sharding_degree": 2},
               "dp2_mp2": {"mp_degree": 2}}[strategy_name]
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = dict(degrees)
    fleet.init(is_collective=True, strategy=strategy)
    hcg = fleet.get_hybrid_communicate_group()
    rank = dist.get_rank()
    d = dict(np.load(IN))
    cfg = GPTConfig(vocab_size=128, hidden_size=32, num_layers=2,
                    num_heads=2, max_seq_len=16,
                    mp_degree=hcg.get_model_parallel_world_size())
    model = GPTForCausalLM(cfg, device="cpu")
    load_jax_state(model, {k[len("gpt/"):]: v for k, v in d.items()
                           if k.startswith("gpt/")})
    model = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(paddle.optimizer.AdamW(
        learning_rate=1e-2, parameters=model.named_parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0) if clip else None))
    # this rank's rows of the global batch: its coordinate over the axes
    # that see different data (dp, then sharding)
    shards = (hcg.get_data_parallel_world_size()
              * hcg.get_sharding_parallel_world_size())
    index = (hcg.get_data_parallel_rank()
             * hcg.get_sharding_parallel_world_size()
             + hcg.get_sharding_parallel_rank())
    batch = d["batch"]
    rows = batch.shape[0] // shards
    ids = torch.from_numpy(batch[index * rows:(index + 1) * rows])
    losses = []
    for _ in range(6):
        _, loss = model(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    buckets = getattr(model, "bucket_count", None)
    with open(os.path.join(OUT, f"train.r{rank}.json"), "w") as f:
        json.dump({"losses": losses, "data_shard": index, "shards": shards,
                   "buckets": buckets}, f)


def fail():
    dist.init_parallel_env()
    rank = dist.get_rank()
    with open(os.path.join(OUT, f"pid.r{rank}"), "w") as f:
        f.write(str(os.getpid()))
    dist.barrier()
    if rank == 1:
        sys.exit(3)
    dist.all_reduce(torch.zeros(1))        # waits for rank 1, which is gone
    with open(os.path.join(OUT, f"finished.r{rank}"), "w") as f:
        f.write("no")


def exit_job(destroy):
    import atexit
    import glob

    def threads():
        # registered before init_parallel_env registers its hook, so it
        # runs after it (atexit is last in, first out)
        names = sorted(open(p).read().strip()
                       for p in glob.glob("/proc/self/task/*/comm"))
        with open(os.path.join(OUT, f"threads.r{rank}.json"), "w") as f:
            json.dump(names, f)
    atexit.register(threads)
    dist.init_parallel_env()
    rank = dist.get_rank()
    dist.set_mesh(dist.build_mesh({"dp": 2, "mp": 2}))
    t = torch.full((4,), float(rank))
    for g in (dist.get_default_group(), dist.new_group(axes="dp"),
              dist.new_group(axes="mp")):
        dist.all_reduce(t, group=g)
    save("exit", rank, x=t)
    if destroy:
        dist.destroy_process_group()


if JOB == "collectives":
    collectives()
elif JOB.startswith("exit"):
    exit_job(JOB == "exit:destroy")
elif JOB == "tp":
    tp()
elif JOB.startswith("train:"):
    parts = JOB.split(":")
    train(parts[1], len(parts) > 2 and parts[2] == "clip")
elif JOB == "fail":
    fail()
else:
    raise SystemExit(f"unknown job {JOB}")
