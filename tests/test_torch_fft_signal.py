"""``fft`` and ``signal`` of the port against the JAX package: every
transform of ``fft`` (1-D, 2-D, N-D, the hermitian pairs, each norm),
the frequency and shift helpers, and ``frame``/``overlap_add``/``stft``/
``istft`` of ``signal``, with gradients through ``rfft`` and ``stft``.
Outputs to 1e-4 of the largest magnitude (float32 transforms)."""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp

TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    with tp.device_guard("cpu"):
        yield


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype.kind == want.dtype.kind
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() <= TOL * scale


RNG = np.random.RandomState(0)
REAL = RNG.randn(4, 6, 8).astype(np.float32)
CPLX = (RNG.randn(4, 6, 8) + 1j * RNG.randn(4, 6, 8)).astype(np.complex64)


@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
@pytest.mark.parametrize("name,x,kw", [
    ("fft", CPLX, {}), ("ifft", CPLX, dict(n=10)), ("rfft", REAL, {}),
    ("irfft", CPLX, dict(n=14)), ("hfft", CPLX, {}), ("ihfft", REAL, {}),
    ("fft2", CPLX, {}), ("ifft2", CPLX, dict(s=(4, 6))),
    ("rfft2", REAL, {}), ("irfft2", CPLX, {}),
    ("fftn", CPLX, dict(axes=(0, 2))), ("ifftn", CPLX, {}),
    ("rfftn", REAL, {}), ("irfftn", CPLX, dict(axes=(1, 2))),
    ("hfft2", CPLX, {}), ("ihfft2", REAL, {}), ("hfftn", CPLX, {}),
    ("ihfftn", REAL, dict(axes=(0, 1)))], ids=lambda v: str(v)[:12])
def test_transforms(name, x, kw, norm):
    want = getattr(jp.fft, name)(jp.to_tensor(x), norm=norm, **kw).numpy()
    got = getattr(tp.fft, name)(tp.to_tensor(x), norm=norm, **kw).numpy()
    close(got, want)


def test_bad_norm_raises():
    with pytest.raises(ValueError, match="norm"):
        tp.fft.fft(tp.to_tensor(CPLX), norm="twice")


def test_helpers():
    close(tp.fft.fftfreq(9, 0.5).numpy(), jp.fft.fftfreq(9, 0.5).numpy())
    close(tp.fft.rfftfreq(8).numpy(), jp.fft.rfftfreq(8).numpy())
    for fn in ("fftshift", "ifftshift"):
        close(getattr(tp.fft, fn)(tp.to_tensor(REAL), axes=(1,)).numpy(),
              getattr(jp.fft, fn)(jp.to_tensor(REAL), axes=(1,)).numpy())


def test_rfft_gradient():
    grads = []
    for pkg in (jp, tp):
        x = pkg.to_tensor(REAL[0], stop_gradient=False)
        spec = pkg.fft.rfft(x, norm="ortho")
        (pkg.abs(spec) ** 2).sum().backward()
        grads.append(x.grad.numpy())
    close(grads[1], grads[0])


@pytest.mark.parametrize("axis", [-1, 0])
def test_frame_and_overlap_add(axis):
    x = RNG.randn(16, 3).astype(np.float32) if axis == 0 else RNG.randn(
        3, 16).astype(np.float32)
    fr = [pkg.signal.frame(pkg.to_tensor(x), 4, 2, axis=axis)
          for pkg in (jp, tp)]
    close(fr[1].numpy(), fr[0].numpy())
    back = [pkg.signal.overlap_add(f, 2, axis=axis) for pkg, f in
            ((jp, fr[0]), (tp, fr[1]))]
    close(back[1].numpy(), back[0].numpy())


@pytest.mark.parametrize("kw", [dict(), dict(center=False, hop_length=3),
                                dict(win_length=12, normalized=True),
                                dict(onesided=False)],
                         ids=["default", "uncentred", "window", "twosided"])
def test_stft_istft(kw):
    x = RNG.randn(2, 64).astype(np.float32)
    n_fft = 16
    win = np.hanning(kw.get("win_length", n_fft)).astype(np.float32)
    specs = [pkg.signal.stft(pkg.to_tensor(x), n_fft,
                             window=pkg.to_tensor(win), **kw)
             for pkg in (jp, tp)]
    close(specs[1].numpy(), specs[0].numpy())
    ikw = {k: v for k, v in kw.items() if k != "pad_mode"}
    outs = [pkg.signal.istft(s, n_fft, window=pkg.to_tensor(win),
                             length=64, **ikw)
            for pkg, s in ((jp, specs[0]), (tp, specs[1]))]
    close(outs[1].numpy(), outs[0].numpy())


def test_stft_gradient_and_one_dim_input():
    grads = []
    x0 = np.random.RandomState(3).randn(40).astype(np.float32)
    for pkg in (jp, tp):
        x = pkg.to_tensor(x0, stop_gradient=False)
        spec = pkg.signal.stft(x, 8, hop_length=2)
        assert list(spec.shape) == [5, 21]
        pkg.abs(spec).sum().backward()
        grads.append(x.grad.numpy())
    close(grads[1], grads[0])


def test_istft_complex_needs_two_sided():
    with pytest.raises(ValueError, match="onesided"):
        tp.signal.istft(tp.to_tensor(CPLX[0]), 8, return_complex=True)

