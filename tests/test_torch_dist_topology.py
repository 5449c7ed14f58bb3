"""The port's distributed bookkeeping against the JAX package's, in one
process: the hybrid topology's rank and coordinate maps and groups for
each axis order, ``DistributedStrategy``, the ZeRO-1 owner map on GPT's
parameters, the launcher's environment contract and its argument
errors, the model-parallel RNG seeds, and ``init_parallel_env``'s refusal
to run without CUDA unless the caller set the CPU."""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as paddle
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.distributed.fleet import DistributedStrategy as JStrategy
from paddle_tpu.distributed.fleet.base import topology as jtopo
from paddle_tpu.distributed.fleet.meta_optimizers import \
    DygraphShardingOptimizer as JSharding
from paddle_tpu.distributed.fleet.mpu import random as jrandom
from paddle_tpu.distributed.launch import main as jlaunch
from paddle_tpu.models import GPTConfig as JGPTConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu_torch.distributed import init_parallel_env
from paddle_tpu_torch.distributed.fleet import DistributedStrategy
from paddle_tpu_torch.distributed.fleet.base import topology
from paddle_tpu_torch.distributed.fleet.meta_optimizers.\
    dygraph_sharding_optimizer import partition_parameters
from paddle_tpu_torch.distributed.fleet.mpu import random as prandom
from paddle_tpu_torch.distributed.launch import main as plaunch
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

LAYOUTS = [
    (("dp", "pp", "sharding", "sep", "mp"), (2, 1, 2, 1, 2)),
    (("dp", "mp"), (2, 4)),
    (("mp", "sharding", "dp"), (2, 2, 2)),
    (("pp", "dp", "sep", "mp", "sharding"), (1, 2, 2, 2, 1)),
]


@pytest.mark.parametrize("names,dims", LAYOUTS)
def test_communicate_topology_equals_the_jax_one(names, dims):
    mine = topology.CommunicateTopology(names, dims)
    theirs = jtopo.CommunicateTopology(names, dims)
    assert mine.world_size() == theirs.world_size()
    for axis in names:
        assert mine.get_comm_list(axis) == theirs.get_comm_list(axis)
        assert mine.get_dim(axis) == theirs.get_dim(axis)
        for i in range(mine.get_dim(axis)):
            assert mine.get_axis_list(axis, i) == theirs.get_axis_list(axis,
                                                                       i)
    for r in range(mine.world_size()):
        c = mine.get_coord(r)
        assert c == theirs.get_coord(r)
        assert mine.get_rank(**dict(zip(names, c))) == r


@pytest.mark.parametrize("names,dims", LAYOUTS)
def test_hybrid_group_equals_the_jax_one(names, dims):
    """Degrees, parallel mode and (rank 0, the coordinate the JAX
    process holds) axis ranks equal the JAX group's over a mesh of the
    same axes; every rank's axis ranks are its topology coordinate."""
    old = jmesh._global_mesh
    try:
        jmesh.set_mesh(jmesh.build_mesh(dict(zip(names, dims)),
                                        devices=jax.devices()[:8]))
        theirs = jtopo.HybridCommunicateGroup(
            jtopo.CommunicateTopology(names, dims))
    finally:
        jmesh._global_mesh = old
    topo = topology.CommunicateTopology(names, dims)
    getters = ("data_parallel", "model_parallel", "sharding_parallel",
               "sep_parallel", "pipe_parallel")
    for r in range(topo.world_size()):
        mine = topology.HybridCommunicateGroup(topo, rank=r)
        assert mine.get_parallel_mode() == theirs.get_parallel_mode()
        for g in getters:
            assert (getattr(mine, f"get_{g}_world_size")() ==
                    getattr(theirs, f"get_{g}_world_size")())
        coord = dict(zip(names, topo.get_coord(r)))
        assert mine.get_data_parallel_rank() == coord["dp"]
        assert mine.get_model_parallel_rank() == coord.get("mp", 0)
        assert mine.get_sharding_parallel_rank() == coord.get("sharding", 0)
        assert mine.get_stage_id() == coord.get("pp", 0)
        if r == 0:
            for g in getters[:4]:
                assert (getattr(mine, f"get_{g}_rank")() ==
                        getattr(theirs, f"get_{g}_rank")())
            assert (mine.get_rank_from_stage(0) ==
                    theirs.get_rank_from_stage(0))
        with pytest.raises(RuntimeError, match="init_parallel_env"):
            mine.get_data_parallel_group()


def test_distributed_strategy_equals_the_jax_one():
    mine, theirs = DistributedStrategy(), JStrategy()
    assert mine.hybrid_configs == theirs.hybrid_configs
    for s in (mine, theirs):
        s.hybrid_configs = {"dp_degree": 2, "mp_degree": 4}
    assert mine.hybrid_configs == theirs.hybrid_configs
    assert mine.hybrid_configs["order"] == ["dp", "pp", "sharding", "sep",
                                            "mp"]
    for attr in ("pipeline_configs", "amp_configs", "sharding_configs",
                 "fuse_grad_size_in_MB", "last_comm_group_size_MB",
                 "find_unused_parameters", "gradient_merge_configs",
                 "tensor_parallel_configs", "hybrid_parallel_order"):
        assert getattr(mine, attr) == getattr(theirs, attr), attr


@pytest.mark.parametrize("degree", [2, 4])
def test_sharding_owner_map_equals_the_jax_one(degree):
    """ZeRO-1's owners of GPT's parameters, by name, equal the JAX
    DygraphShardingOptimizer's map over the JAX model's."""
    kw = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
              max_seq_len=16)
    jm = JGPT(JGPTConfig(use_flash_attention=False, **kw))
    old = jmesh._global_mesh
    try:
        jmesh.set_mesh(jmesh.build_mesh({"dp": 8 // degree,
                                         "sharding": degree}))
        jopt = JSharding(jpaddle.optimizer.AdamW(
            parameters=jm.parameters()), axis="sharding")
    finally:
        jmesh._global_mesh = old
    jname = {id(p): n for n, p in jm.named_parameters()}
    theirs = {r: [jname[id(p)] for p in ps]
              for r, ps in jopt._rank2params.items()}
    model = GPTForCausalLM(GPTConfig(**kw), device="cpu")
    names = {id(p): n for n, p in model.named_parameters()}
    mine = {r: [names[id(p)] for p in ps] for r, ps in partition_parameters(
        list(model.parameters()), degree).items()}
    assert mine == theirs


def _args(argv):
    return plaunch._parse(argv + ["train.py", "--lr", "0.1"])


def test_launcher_environment_contract():
    """Each rank's environment: the JAX launcher's Paddle names with the
    JAX launcher's values, and torch's."""
    args = _args(["--nproc_per_node", "4", "--master", "10.0.0.1:6170"])
    jargs = jlaunch._parse(["--nproc_per_node", "4", "--master",
                            "10.0.0.1:6170", "train.py"])
    jargs.nnodes_now, jargs.ps_token = 1, ""
    assert args.training_script_args == ["--lr", "0.1"]
    for local in range(4):
        env = plaunch.worker_env(args, local, base={})
        jenv = jlaunch._worker_env(jargs, local)
        for key in ("PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM",
                    "PADDLE_LOCAL_RANK", "PADDLE_MASTER"):
            assert env[key] == jenv[key], key
        assert env["RANK"] == env["LOCAL_RANK"] == str(local)
        assert env["WORLD_SIZE"] == "4"
        assert (env["MASTER_ADDR"], env["MASTER_PORT"]) == ("10.0.0.1",
                                                            "6170")
    assert plaunch.worker_env(args, 2, base={"KEEP": "1"})["KEEP"] == "1"


@pytest.mark.parametrize("argv,error", [
    (["--max_restarts", "2"], NotImplementedError),
    (["--master", "nohostport"], SystemExit),
    (["--nproc_per_node", "0"], SystemExit),
    (["--master", "127.0.0.1:port"], SystemExit),
])
def test_launcher_argument_errors(argv, error):
    with pytest.raises(error) as info:
        _args(argv)
    if error is NotImplementedError:
        assert "fault tolerance" in str(info.value)


class _HCG:
    def __init__(self, mp_rank):
        self.mp_rank = mp_rank

    def get_model_parallel_rank(self):
        return self.mp_rank


@pytest.mark.parametrize("failures,cause", [
    ([(0, 1), (1, 3)], (1, 3)),       # the peer's collective error came first
    ([(1, 3), (0, 1)], (1, 3)),
    ([(0, -6), (1, 1)], (0, -6)),     # no program exit code: the first
    ([(2, 1)], (2, 1)),
])
def test_launcher_names_the_failure_the_others_followed(failures, cause):
    """A rank's own exit code above 1 wins over the collateral failures
    (code 1, signals) that can reach the launcher before it."""
    assert plaunch._cause(failures) == cause


def test_model_parallel_seeds():
    """mp rank 0's stream has the JAX package's seed (seed + 1024); mp
    ranks differ, ranks of one mp coordinate (dp peers) agree; the lazy
    seed of an unnamed stream is the JAX package's derivation, never
    hash()."""
    jrandom.model_parallel_random_seed(5)
    want = jrandom.determinate_seed()
    seeds = {}
    for mp in (0, 1, 0):
        seeds.setdefault(mp, set()).add(
            prandom.model_parallel_random_seed(5, _HCG(mp)))
    assert seeds[0] == {want} and len(seeds[1]) == 1 and seeds[0] != seeds[1]
    tracker = prandom.get_rng_state_tracker()
    gen = tracker.generator(device="cpu")
    assert gen.initial_seed() == want
    jpaddle.seed(77)
    jrandom.get_rng_state_tracker().reset()
    paddle.seed(77)
    tracker.reset()
    assert tracker.seed_of("dropout_region") == \
        jrandom.determinate_seed("dropout_region")
    with pytest.raises(ValueError, match="already exists"):
        tracker.add("dropout_region", 3)
    # a stream swapped into the Paddle API draws on, and is restored
    with paddle.device_guard("cpu"):
        before = paddle.core.generator.default_generator().get_state()
        with tracker.rng_state("dropout_region"):
            a = paddle.rand([4]).numpy()
        with tracker.rng_state("dropout_region"):
            b = paddle.rand([4]).numpy()
        after = paddle.core.generator.default_generator().get_state()
    assert not np.array_equal(a, b) and torch.equal(before, after)


def test_init_parallel_env_needs_cuda_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_parallel_env()
    assert not torch.distributed.is_initialized()
