"""Device RNG state helpers (counterpart of
``paddle_tpu/framework/random.py``): the "cuda" names read and set the
current device's Paddle-API generator."""
from ..core.generator import get_rng_state, set_rng_state


def get_cuda_rng_state():
    return get_rng_state()


def set_cuda_rng_state(state):
    return set_rng_state(state)
