"""The port's speech surface against the JAX package on the CPU:
``paddle_tpu_torch.fft`` (all 18 functions, their ``n``/``s``/``norm``
checks), ``signal`` (``frame``, ``overlap_add``, ``stft``, ``istft``),
the audio functions and the four feature layers, and the four metrics.
Inputs come from numpy seeds; float32, within 1e-5 of each output's
largest magnitude (a spectrum's entries span many orders)."""

import torch_threads  # noqa: F401  (first: caps torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import jit_o0, scaled_close

from paddle_tpu import audio as jaudio
from paddle_tpu import fft as jfft
from paddle_tpu import metric as jmetric
from paddle_tpu import signal as jsignal
from paddle_tpu_torch import audio as taudio
from paddle_tpu_torch import errors
from paddle_tpu_torch import fft as tfft
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import signal as tsignal


def _parts(x):
    """Real and imaginary parts side by side, as float64 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().resolve_conj()
        x = torch.view_as_real(x) if x.is_complex() else x
        return x.double().numpy()
    x = np.asarray(x)
    if np.iscomplexobj(x):
        x = np.stack([x.real, x.imag], -1)
    return x.astype(np.float64)


def cclose(got, want, tol=1e-5):
    g, w = _parts(got), _parts(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    scaled_close(g, w, tol)


def _real(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _complex(*shape, seed=0):
    return (_real(*shape, seed=seed)
            + 1j * _real(*shape, seed=seed + 1)).astype(np.complex64)


# (id, function, input, keyword arguments)
FFT_CASES = [
    ("fft", "fft", _complex(3, 16), {}),
    ("fft_n_ortho", "fft", _real(3, 16), dict(n=20, norm="ortho")),
    ("ifft_forward_axis0", "ifft", _complex(12, 4), dict(axis=0,
                                                          norm="forward")),
    ("rfft_n", "rfft", _real(2, 17), dict(n=12)),
    ("irfft", "irfft", _complex(2, 9), dict(n=16)),
    ("hfft", "hfft", _complex(2, 9), dict(n=16, norm="ortho")),
    ("ihfft", "ihfft", _real(2, 16), {}),
    ("fft2", "fft2", _complex(2, 6, 8), {}),
    ("ifft2_s", "ifft2", _complex(2, 6, 8), dict(s=(4, 10), norm="ortho")),
    ("rfft2_axes", "rfft2", _real(6, 2, 8), dict(axes=(0, 2))),
    ("irfft2", "irfft2", _complex(2, 6, 5), dict(s=(6, 8))),
    ("fftn", "fftn", _complex(2, 4, 6), {}),
    ("ifftn_axes", "ifftn", _complex(2, 4, 6), dict(axes=(1, 2),
                                                     norm="forward")),
    ("rfftn_s", "rfftn", _real(4, 6, 8), dict(s=(4, 8))),
    ("irfftn", "irfftn", _complex(4, 6, 5), dict(s=(4, 6, 8))),
    ("fftshift", "fftshift", _real(5, 6), {}),
    ("ifftshift_axes", "ifftshift", _real(5, 6), dict(axes=(1,))),
]


@pytest.mark.parametrize("cid", [c[0] for c in FFT_CASES])
def test_fft_matches_jax(cid):
    _, fn, x, kw = next(c for c in FFT_CASES if c[0] == cid)
    got = getattr(tfft, fn)(torch.as_tensor(x), **kw)
    want = getattr(jfft, fn)(jnp.asarray(x), **kw)
    assert got.is_complex() == jnp.iscomplexobj(want)
    cclose(got, want)


def test_fft_frequencies_and_checks_match_jax():
    for fn in ("fftfreq", "rfftfreq"):
        got = getattr(tfft, fn)(10, 0.5, device="cpu")
        want = getattr(jfft, fn)(10, 0.5)
        assert got.dtype == torch.float32
        cclose(got, want)
    assert tfft.fftfreq(8, dtype="float64", device="cpu").dtype == \
        torch.float64
    x = torch.as_tensor(_real(8))
    with pytest.raises(errors.InvalidArgumentError, match="norm"):
        tfft.fft(x, norm="none")
    with pytest.raises(ValueError, match="positive"):  # is-a ValueError
        tfft.rfft(x, n=0)
    with pytest.raises(errors.InvalidArgumentError, match="positive"):
        tfft.fft2(x.reshape(2, 4), s=(2, -1))
    with pytest.raises(errors.InvalidArgumentError):
        tfft.fftfreq(0, device="cpu")
    cclose(tfft.fft(x, norm=None), jfft.fft(jnp.asarray(_real(8))))


def test_errors_taxonomy_is_the_jax_one():
    from paddle_tpu import errors as jerrors

    assert errors.__all__ == jerrors.__all__
    for name in errors.__all__:
        ours, theirs = getattr(errors, name), getattr(jerrors, name)
        if isinstance(ours, type):
            assert ours.code == theirs.code
            assert [b.__name__ for b in ours.__mro__] == \
                [b.__name__ for b in theirs.__mro__]
    with pytest.raises(errors.OutOfRangeError, match=r"\(OUT_OF_RANGE\)"):
        errors.enforce_gt(1, 2, error_cls=errors.OutOfRangeError)
    errors.enforce_shape_match((2, 3), (None, 3))
    with pytest.raises(ValueError, match="shape mismatch"):
        errors.enforce_shape_match((2, 3), (2, 4))
    with pytest.raises(errors.InvalidArgumentError, match="one of"):
        errors.enforce_in("c", ("a", "b"))


# (id, function, input builder, positional and keyword arguments)
SIGNAL_CASES = [
    ("frame", "frame", lambda: _real(2, 3, 50), (16, 5), {}),
    ("frame_axis0", "frame", lambda: _real(50, 2), (16, 5), dict(axis=0)),
    ("overlap_add", "overlap_add", lambda: _real(2, 16, 7), (5,), {}),
    ("overlap_add_axis0", "overlap_add", lambda: _real(7, 16, 3), (5,),
     dict(axis=0)),
    ("stft", "stft", lambda: _real(2, 400), (64, 16, 64),
     dict(window=np.hanning(64).astype(np.float32))),
    ("stft_short_window_normalized", "stft", lambda: _real(3, 300),
     (64, None, 48), dict(window=np.hanning(48).astype(np.float32),
                          normalized=True)),
    ("stft_constant_pad", "stft", lambda: _real(2, 2, 256), (32,),
     dict(pad_mode="constant")),
    ("stft_uncentred", "stft", lambda: _real(200), (32, 8),
     dict(center=False)),
    ("stft_complex_twosided", "stft", lambda: _complex(2, 200), (32, 8),
     dict(onesided=False)),
    ("istft", "istft", None, (64, 16, 64),
     dict(window=np.hanning(64).astype(np.float32))),
    ("istft_length", "istft", None, (64, 16, 64),
     dict(window=np.hanning(64).astype(np.float32), length=380)),
    ("istft_twosided_complex", "istft", "twosided", (64, 16),
     dict(onesided=False, return_complex=True)),
]


def _signal_input(build):
    if callable(build):
        return build()
    x = _complex(2, 400) if build == "twosided" else _real(2, 400)
    # the spectrum of the port: held against JAX's in the stft cases
    return tsignal.stft(torch.as_tensor(x), 64, 16, window=torch.as_tensor(
        np.hanning(64), dtype=torch.float32),
        onesided=build != "twosided").numpy()


@pytest.mark.parametrize("cid", [c[0] for c in SIGNAL_CASES])
def test_signal_matches_jax(cid):
    _, fn, build, args, kw = next(c for c in SIGNAL_CASES if c[0] == cid)
    x = _signal_input(build)
    tkw = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    got = getattr(tsignal, fn)(torch.as_tensor(x), *args, **tkw)
    want = jit_o0(lambda a: getattr(jsignal, fn)(a, *args, **kw), x)
    cclose(got, want)


def test_istft_inverts_stft():
    x = torch.as_tensor(_real(2, 400))
    w = torch.hann_window(64, periodic=False)
    spec = tsignal.stft(x, 64, 16, window=w)
    back = tsignal.istft(spec, 64, 16, window=w, length=400)
    torch.testing.assert_close(back, x, rtol=1e-5, atol=1e-5)


def test_stft_gradient_matches_jax():
    x = _real(2, 300)
    w = np.hanning(64).astype(np.float32)

    def jpower(a):
        return jnp.sum(jnp.abs(jsignal.stft(a, 64, 16, window=w)) ** 2)

    want = jit_o0(jax.grad(jpower), x)
    xt = torch.tensor(x, requires_grad=True)
    (tsignal.stft(xt, 64, 16, window=torch.as_tensor(w)).abs() ** 2
     ).sum().backward()
    scaled_close(xt.grad, want)


def test_audio_functions_match_jax():
    from paddle_tpu.audio import functional as JAF
    from paddle_tpu_torch.audio import functional as TAF

    for name in ("hann", "hamming", "blackman", "bartlett", "triang",
                 ("kaiser", 8.0), ("gaussian", 5.0), "rect"):
        for fftbins in (True, False):
            np.testing.assert_array_equal(
                TAF.get_window(name, 33, fftbins),
                JAF.get_window(name, 33, fftbins))
    for htk in (False, True):
        np.testing.assert_array_equal(TAF.mel_frequencies(40, 20, 8000, htk),
                                      JAF.mel_frequencies(40, 20, 8000, htk))
        np.testing.assert_array_equal(
            TAF.compute_fbank_matrix(16000, 512, 80, htk=htk, norm=None),
            JAF.compute_fbank_matrix(16000, 512, 80, htk=htk, norm=None))
    np.testing.assert_array_equal(TAF.create_dct(13, 40, None),
                                  JAF.create_dct(13, 40, None))
    s = np.abs(_real(4, 30)) ** 3
    for top_db in (None, 40.0):
        got = TAF.power_to_db(torch.as_tensor(s), 0.5, 1e-4, top_db)
        cclose(got, JAF.power_to_db(jnp.asarray(s), 0.5, 1e-4, top_db))


FEATURES = [
    ("Spectrogram", dict(n_fft=512, hop_length=160)),
    ("MelSpectrogram", dict(sr=16000, n_fft=512, hop_length=160,
                            n_mels=80)),
    ("LogMelSpectrogram", dict(sr=16000, n_fft=512, hop_length=160,
                               n_mels=80, top_db=80.0)),
    ("MFCC", dict(sr=16000, n_mfcc=20, n_fft=512, hop_length=160,
                  n_mels=80, window="hamming", htk=True)),
]


@pytest.mark.parametrize("name,kw", FEATURES, ids=[f[0] for f in FEATURES])
def test_audio_feature_layer_matches_jax(name, kw):
    t = np.arange(4000) / 16000.0
    wave = (np.sin(2 * np.pi * 440 * t)[None] + 0.1 * _real(2, 4000)).astype(
        np.float32)
    tlayer = getattr(taudio, name)(**kw, device="cpu")
    jlayer = getattr(jaudio, name)(**kw)
    assert set(tlayer.state_dict()) == set(jlayer.state_dict()) == set()
    got = tlayer(torch.as_tensor(wave))
    want = jit_o0(lambda a: jlayer(a), wave)
    assert got.dtype == torch.float32
    cclose(got, want)


def _preds(seed, n=64, k=5):
    rng = np.random.default_rng(seed)
    return (rng.random((n, k)).astype(np.float32),
            rng.integers(0, k, (n, 1)))


def test_metrics_match_jax_on_tensors():
    """Tensors in (float32 and bf16, as a card's would be copied), numpy
    on the JAX side: the same accumulated values, batch after batch."""
    pairs = [(tmetric.Accuracy(topk=(1, 2)), jmetric.Accuracy(topk=(1, 2))),
             (tmetric.Precision(), jmetric.Precision()),
             (tmetric.Recall(), jmetric.Recall()),
             (tmetric.Auc(num_thresholds=255), jmetric.Auc(num_thresholds=255))]
    for step in range(3):
        scores, labels = _preds(step)
        probs = scores[:, 0]
        binary = (labels[:, 0] % 2).astype(np.int64)
        feeds = [(scores, labels), (probs, binary), (probs, binary),
                 (np.stack([1 - probs, probs], 1), binary)]
        for (ours, theirs), (p, lab) in zip(pairs, feeds):
            dtype = torch.bfloat16 if step == 1 else torch.float32
            pt = torch.as_tensor(p).to(dtype)
            ours.update(pt, torch.as_tensor(lab))
            theirs.update(pt.float().numpy(), lab)
            assert ours.accumulate() == theirs.accumulate()
    assert [m.name() for m, _ in pairs] == [m.name() for _, m in pairs]
    acc = pairs[0][0]
    acc.reset()
    assert acc.accumulate() == [0.0, 0.0]
    scores, labels = _preds(7)
    onehot = np.eye(5)[labels[:, 0]]
    assert acc.update(torch.as_tensor(scores), torch.as_tensor(onehot)) == \
        jmetric.Accuracy(topk=(1, 2)).update(scores, onehot)
