"""Spectrogram utilities for training: STFT magnitude and the log-mel loss input.

Counterpart of ``vits_tpu/utils/mel.py``: frames cut with reflect padding, a
periodic Hann window, ``rfft`` and magnitude -- spelled out rather than
``torch.stft`` so the framing is the JAX package's by construction. The
Slaney mel filterbank is the JAX package's numpy one (JAX-free), imported.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (fp32), as ``vits_tpu.utils.mel.hann_window``."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * n / win_length)).astype(np.float32)


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """numpy's ``mode="reflect"`` on the last axis, also for pads past the length
    (where ``F.pad`` refuses): the mirror extension of period 2 (T - 1)."""
    T = x.shape[-1]
    period = 2 * (T - 1)
    idx = torch.arange(-pad, T + pad, device=x.device).remainder(period)
    return x[..., torch.where(idx >= T, period - idx, idx)]


def stft_magnitude(
    audio: torch.Tensor,  # (B, T)
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    center: bool = True,
) -> torch.Tensor:
    """|STFT| -> (B, frames, n_fft//2 + 1)."""
    if center:
        audio = _reflect_pad(audio, n_fft // 2)
    window = torch.tensor(hann_window(win_length), device=audio.device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    frames = audio.unfold(-1, n_fft, hop_length) * window  # (B, frames, n_fft)
    return torch.fft.rfft(frames, dim=-1).abs()


@functools.lru_cache(maxsize=8)
def _filterbank(n_mels: int, n_fft: int, sample_rate: int) -> np.ndarray:
    # the numpy half of vits_tpu/utils/mel.py; that module imports jax, so
    # the construction is carried here unchanged
    fmax = sample_rate / 2.0

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        return np.where(f >= 1000.0,
                        15.0 + np.log(np.maximum(f, 1e-9) / 1000.0) / (np.log(6.4) / 27.0),
                        3.0 * f / 200.0)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)),
                        200.0 * m / 3.0)

    freqs_mel = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(fmax), n_mels + 2))
    fft_freqs = np.linspace(0, sample_rate / 2.0, n_fft // 2 + 1)
    weights = np.zeros((n_mels, len(fft_freqs)))
    fdiff = np.diff(freqs_mel)
    ramps = freqs_mel[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    weights *= (2.0 / (freqs_mel[2: n_mels + 2] - freqs_mel[:n_mels]))[:, None]
    return weights.T.astype(np.float32)  # (bins, n_mels)


def mel_filterbank(n_mels: int = 80, n_fft: int = 1024, sample_rate: int = 16000) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, (n_fft//2+1, n_mels)."""
    return _filterbank(n_mels, n_fft, sample_rate)


def log_mel_spectrogram(
    audio: torch.Tensor,  # (B, T)
    n_mels: int = 80,
    n_fft: int = 1024,
    hop_length: int = 256,
    sample_rate: int = 16000,
) -> torch.Tensor:
    mag = stft_magnitude(audio, n_fft=n_fft, hop_length=hop_length, win_length=n_fft)
    fb = torch.tensor(mel_filterbank(n_mels, n_fft, sample_rate), device=audio.device)
    return torch.log(torch.clamp(mag @ fb, min=1e-5))
