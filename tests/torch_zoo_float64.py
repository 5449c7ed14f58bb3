"""How far fp32 is from exact in the zoo's train steps: the referee
behind the deep models' bounds (``tests/torch_vision_zoo.py``
DEEP_TOLS) and the chip phase's ZOO_GRAD_TOL (``chip_smoke.py``).

A float64 run of the port (its batch norm and loss kept in float64) is
the referee. For each case it prints the largest distance, over the
outputs, of the fp32 port and the fp32 JAX program (``jax_step``) from
it, and the same for the gradients (norm-wise, each parameter against
the larger of its norm and GRAD_FLOOR of the largest), on the CPU:

    JAX_PLATFORMS=cpu python tests/torch_zoo_float64.py            # tests
    JAX_PLATFORMS=cpu python tests/torch_zoo_float64.py --phase    # chip

``--phase`` runs the chip phase's train-step models (1000 classes, B2,
224x224, seeded weights) without JAX: the fp32 port on the CPU against
float64, the rounding the card's fp32 carries too.
"""
import sys

import numpy as np
import torch

import paddle_tpu_torch as tp
import paddle_tpu_torch.nn.functional.norm as _norm

# (model, size, batch) of the zoo tests with DEEP_TOLS (and
# InceptionV3 at its smallest input), and the phase's
TEST_CASES = (("googlenet", 64, 8), ("densenet121", 64, 8),
              ("inception_v3", 107, 8), ("inception_v3", 75, 2))
PHASE_CASES = (("mobilenet_v2", 224, 2), ("mobilenet_v3_large", 224, 2),
               ("googlenet", 224, 2))

_fp32_float = torch.Tensor.float
_fp32_params = _norm._f32


def _keep_float64(on):
    """The port's batch norm and loss cast to fp32 (``.float()``); with
    ``on`` a float64 tensor stays float64 through them."""
    if on:
        torch.Tensor.float = lambda self, *a, **k: (
            self if self.dtype == torch.float64
            else _fp32_float(self, *a, **k))
        _norm._f32 = lambda t: t
    else:
        torch.Tensor.float = _fp32_float
        _norm._f32 = _fp32_params


def _float64_twin(name, state, **kw):
    with tp.device_guard("cpu"):
        twin = getattr(tp.vision.models, name)(**kw)
        twin.set_state_dict(state)
        for p in twin.parameters():
            p._data = p._data.detach().double().requires_grad_(True)
        for b in twin.buffers():
            b._data = b._data.double()
    return twin


def _distances(got, ref, floor):
    outs = max(float(np.abs(a - b).max()) / max(1.0, float(np.abs(b).max()))
               for a, b in zip(got[0] + got[2], ref[0] + ref[2]))
    largest = max(np.linalg.norm(g) for g in ref[3])
    grads = max(float(np.linalg.norm(a.astype(np.float64) - b)
                      / max(np.linalg.norm(b), floor * largest))
                for a, b in zip(got[3], ref[3]))
    flat = np.concatenate([a.ravel() for a in got[3]]).astype(np.float64)
    flat_ref = np.concatenate([b.ravel() for b in ref[3]])
    whole = float(np.linalg.norm(flat - flat_ref) / np.linalg.norm(flat_ref))
    return outs, grads, whole


def zoo_test_cases(cases=TEST_CASES):
    import torch_vision_zoo as Z
    for name, size, n in cases:
        j, t = Z.pair(name, num_classes=Z.CLASSES)
        state = {k: v.numpy() for k, v in t.state_dict().items()}
        t64 = _float64_twin(name, state, num_classes=Z.CLASSES)
        Z._no_dropout(t64)
        x, y = Z.batch(size, n=n)
        got_j = Z.jax_step(j, x, y)
        with tp.device_guard("cpu"):
            got_t = Z.port_step(t, x, y)
            _keep_float64(True)
            try:
                ref = Z.port_step(t64, torch.from_numpy(x.astype(
                    np.float64)), y)
            finally:
                _keep_float64(False)
        for label, got in (("port", got_t), ("JAX", got_j)):
            o, g, whole = _distances(got, ref, Z.GRAD_FLOOR)
            print(f"{name} {size}x{size} B{n}: fp32 {label} from float64: "
                  f"outputs {o:.3g}, gradients {g:.3g} (worst "
                  f"parameter), {whole:.3g} (all as one vector)")


def phase_cases():
    from paddle_tpu_torch.nn import functional as F
    for name, size, n in PHASE_CASES:
        with tp.device_guard("cpu"):
            tp.seed(31)
            m = getattr(tp.vision.models, name)(num_classes=1000)
            state = {k: v.numpy() for k, v in m.state_dict().items()}
            m64 = _float64_twin(name, state, num_classes=1000)
            x = np.random.RandomState(40).randn(n, 3, size, size).astype(
                np.float32)
            y = np.random.RandomState(50).randint(0, 1000, n)
            grads = []
            for model, xs, wide in ((m, tp.to_tensor(x), False),
                                    (m64, tp.to_tensor(torch.from_numpy(
                                        x.astype(np.float64))), True)):
                for layer in model.sublayers():
                    if type(layer).__name__ == "Dropout":
                        layer.p = 0.0
                _keep_float64(wide)
                try:
                    model.train()
                    out = model(xs)
                    heads = list(out) if isinstance(out, (list, tuple)) \
                        else [out]
                    lab = tp.to_tensor(y)
                    loss = F.cross_entropy(heads[0], lab)
                    for aux in heads[1:]:
                        loss = loss + 0.3 * F.cross_entropy(aux, lab)
                    loss.backward()
                finally:
                    _keep_float64(False)
                grads.append([p.grad.numpy().astype(np.float64)
                              for p in model.parameters()])
        largest = max(np.linalg.norm(g) for g in grads[1])
        worst = max(float(np.linalg.norm(a - b)
                          / max(np.linalg.norm(b), 1e-3 * largest))
                    for a, b in zip(*grads))
        print(f"{name} {size}x{size} B{n} 1000 classes: fp32 port from "
              f"float64: gradients {worst:.3g}")


if __name__ == "__main__":
    if "--phase" in sys.argv:
        phase_cases()
    elif len(sys.argv) == 4:                  # one case: model size batch
        zoo_test_cases([(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))])
    else:
        zoo_test_cases()
