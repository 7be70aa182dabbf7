"""Port frontend (nemo preset log-mel) against the JAX frontend."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from reazonspeech_tpu.frontend.features import log_mel_spectrogram as jax_log_mel
from reazonspeech_tpu.frontend.features import nemo_frontend_config as jax_nemo_cfg
from reazonspeech_tpu.frontend.mel import mel_filterbank as jax_mel_filterbank
from reazonspeech_tpu_torch.frontend.features import log_mel_spectrogram, nemo_frontend_config
from reazonspeech_tpu_torch.frontend.mel import mel_filterbank


@pytest.mark.parametrize("n,lengths", [(16000, [16000, 9000, 401]),
                                        (24321, [24321, 24000, 0])])
def test_nemo_log_mel_matches_jax(n, lengths):
    """Both run fp32 at full precision; features agree to 1e-5 of max|x|
    (the summation order of the DFT and mel matmuls differs)."""
    rng = np.random.default_rng(n)
    wav = (rng.standard_normal((len(lengths), n)) * 0.1).astype(np.float32)
    for i, n_valid in enumerate(lengths):
        wav[i, n_valid:] = 0.0
    lens = np.asarray(lengths, np.int32)

    want, want_len = jax_log_mel(jnp.asarray(wav), jnp.asarray(lens), jax_nemo_cfg())
    got, got_len = log_mel_spectrogram(torch.from_numpy(wav), torch.from_numpy(lens),
                                       nemo_frontend_config())
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 1e-5 * scale


def test_mel_filterbank_is_the_reference():
    for scale, norm, dom in [("slaney", "slaney", "hz"), ("htk", None, "mel")]:
        np.testing.assert_array_equal(
            mel_filterbank(80, 512, 16000, scale=scale, norm=norm, triangle_domain=dom),
            jax_mel_filterbank(80, 512, 16000, scale=scale, norm=norm, triangle_domain=dom))


def test_unported_presets_raise():
    """The nemo, kaldi and espnet presets are ported; other windows (the
    hamming one), other powers and normalizations, and per-frame
    preprocessing on centred frames raise."""
    for overrides in (dict(window="hamming"), dict(mag_power=1.0),
                      dict(normalize="per_utterance"), dict(remove_dc=True)):
        with pytest.raises(ValueError):
            log_mel_spectrogram(torch.zeros(1, 1600), torch.tensor([1600]),
                                nemo_frontend_config(**overrides))
