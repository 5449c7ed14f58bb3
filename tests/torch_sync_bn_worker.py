"""A rank of ``test_torch_nn_layers.py``'s SyncBatchNorm check: two gloo
processes, each with half of one batch; it imports no JAX."""
import numpy as np
import torch.distributed as dist


def run(rank, port, queue):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        import paddle_tpu_torch as paddle
        paddle.set_device("cpu")
        x = np.random.RandomState(0).randn(4, 3, 5, 5).astype(np.float32)
        part = paddle.to_tensor(x[2 * rank:2 * rank + 2], stop_gradient=False)
        sync = paddle.nn.SyncBatchNorm(3)
        out = sync(part)
        (out * out).sum().backward()
        queue.put((rank, out.numpy(), part.grad.numpy(), sync._mean.numpy(),
                   sync._variance.numpy()))
    finally:
        dist.destroy_process_group()
