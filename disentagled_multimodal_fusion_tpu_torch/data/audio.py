"""Audio featurization: WAV decode, sinc resample, MFCC.

A copy of ``disentagled_multimodal_fusion_tpu/data/audio.py`` (numpy only).

Replaces the reference's torchaudio path (dataset_luma.py:238-295):
wav -> resample 16 kHz -> mono -> pad/trim 3 s -> 40-MFCC
(MelSpectrogram n_fft=400, hop 200, periodic Hann, reflect-center, power 2,
HTK mel, 40 mels, no filterbank norm; AmplitudeToDB power -> 10*log10 with
1e-10 floor; orthonormal DCT-II) -> time-mean.

This module is the pure-numpy implementation; ``data/native_featurizer.py`` binds
a C++ drop-in for the batch offline pass (the reference decodes per sample
per epoch inside __getitem__ — its I/O hot loop; we featurize once).
"""

from __future__ import annotations

import math
import wave
from typing import Tuple

import numpy as np


# ------------------------------------------------------------------ WAV IO
def _read_wav_float(path: str) -> Tuple[np.ndarray, int]:
    """Minimal RIFF parser for IEEE-float WAVs (fmt tag 3 / extensible),
    which the stdlib wave module rejects ('unknown format: 3') — without
    this the numpy fallback's input domain is narrower than the native
    decoder's."""
    import struct

    with open(path, "rb") as f:
        if f.read(4) != b"RIFF":
            raise ValueError("not a RIFF file")
        f.read(4)
        if f.read(4) != b"WAVE":
            raise ValueError("not a WAVE file")
        fmt = channels = bits = rate = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            tag, sz = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            body = f.read(sz)
            if sz & 1:
                f.read(1)  # RIFF pad byte
            if tag == b"fmt ":
                fmt, channels, rate = struct.unpack("<HHI", body[:8])
                bits = struct.unpack("<H", body[14:16])[0]
                if fmt == 0xFFFE and len(body) >= 26:
                    fmt = struct.unpack("<H", body[24:26])[0]
            elif tag == b"data":
                data = body
        if fmt != 3 or data is None or not channels:
            raise ValueError(f"unsupported WAV (fmt={fmt})")
        dt = {32: "<f4", 64: "<f8"}.get(bits)
        if dt is None:
            raise ValueError(f"unsupported float width {bits}")
        arr = np.frombuffer(data, dtype=dt).astype(np.float32)
    return arr.reshape(-1, channels).T.copy(), rate


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a PCM/float WAV file -> (float32 (channels, n), sample_rate)."""
    try:
        with wave.open(str(path), "rb") as w:
            n_channels = w.getnchannels()
            width = w.getsampwidth()
            rate = w.getframerate()
            n = w.getnframes()
            raw = w.readframes(n)
    except wave.Error:
        # stdlib wave rejects IEEE-float WAVs; parse those directly
        return _read_wav_float(path)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        # Heuristic: wave module reports PCM only; treat 4-byte as int32.
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        data = vals.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported sample width {width}")
    return data.reshape(-1, n_channels).T.copy(), rate


# --------------------------------------------------------------- resample
def resample(
    waveform: np.ndarray,
    orig_freq: int,
    new_freq: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> np.ndarray:
    """Band-limited sinc interpolation resampler (torchaudio's algorithm:
    Hann-windowed sinc kernels over the gcd-reduced rate pair)."""
    if orig_freq == new_freq:
        return waveform
    gcd = math.gcd(int(orig_freq), int(new_freq))
    orig = int(orig_freq) // gcd
    new = int(new_freq) // gcd

    base_freq = min(orig, new) * rolloff / 2.0  # half the cutoff, in gcd units
    width = int(math.ceil(lowpass_filter_width * orig / (2.0 * base_freq)))

    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = (-np.arange(new, dtype=np.float64)[:, None] / new + idx) * 2.0 * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    scale = base_freq / (orig / 2.0)
    kernels = np.where(t == 0, 1.0, np.sinc(t)) * window * scale  # (new, K)

    c, n = waveform.shape
    x = np.pad(waveform.astype(np.float64), ((0, 0), (width, width + orig)))
    target_len = int(math.ceil(new * n / orig))
    k = kernels.shape[1]
    out = np.zeros((c, new, target_len // new + 2), dtype=np.float64)
    n_strides = (x.shape[1] - k) // orig + 1
    strided = np.lib.stride_tricks.as_strided(
        x,
        shape=(c, n_strides, k),
        strides=(x.strides[0], x.strides[1] * orig, x.strides[1]),
    )
    # (c, S, K) x (new, K) -> (c, new, S)
    conv = np.einsum("csk,pk->cps", strided, kernels)
    out[:, :, : conv.shape[2]] = conv[:, :, : out.shape[2]]
    res = out.transpose(0, 2, 1).reshape(c, -1)[:, :target_len]
    return res.astype(np.float32)


# ------------------------------------------------------------------- MFCC
def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(
    n_freqs: int, f_min: float, f_max: float, n_mels: int, sample_rate: int
) -> np.ndarray:
    """HTK-mel triangular filterbank, no norm (torchaudio melscale_fbanks)."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel_htk(f_min), hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]                       # (n_mels+1,)
    slopes = f_pts[None, :] - all_freqs[:, None]          # (n_freqs, n_mels+2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)                          # (n_freqs, n_mels)


def dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """Orthonormal DCT-II basis, (n_mels, n_mfcc) (torchaudio create_dct)."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)
    dct = np.cos(np.pi / n_mels * (n[:, None] + 0.5) * k[None, :])
    dct *= np.sqrt(2.0 / n_mels)
    dct[:, 0] *= 1.0 / np.sqrt(2.0)
    return dct.astype(np.float32)


def power_spectrogram(
    waveform: np.ndarray, n_fft: int = 400, hop_length: int = 200
) -> np.ndarray:
    """|STFT|^2 with periodic Hann window and reflect center padding.

    waveform: (n,) -> (n_fft//2+1, frames).
    """
    window = np.hanning(n_fft + 1)[:-1].astype(np.float64)  # periodic Hann
    pad = n_fft // 2
    x = np.pad(waveform.astype(np.float64), (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop_length
    strided = np.lib.stride_tricks.as_strided(
        x,
        shape=(n_frames, n_fft),
        strides=(x.strides[0] * hop_length, x.strides[0]),
    )
    spec = np.fft.rfft(strided * window, axis=1)
    return (spec.real**2 + spec.imag**2).T.astype(np.float32)


def mfcc(
    waveform: np.ndarray,
    sample_rate: int = 16000,
    n_mfcc: int = 40,
    n_mels: int = 40,
    n_fft: int = 400,
    hop_length: int = 200,
) -> np.ndarray:
    """MFCC frames, (n_mfcc, frames) (torchaudio.transforms.MFCC semantics)."""
    spec = power_spectrogram(waveform, n_fft=n_fft, hop_length=hop_length)
    fb = mel_filterbank(n_fft // 2 + 1, 0.0, sample_rate / 2.0, n_mels, sample_rate)
    mel = fb.T @ spec                                   # (n_mels, frames)
    mel_db = 10.0 * np.log10(np.maximum(mel, 1e-10))
    return (dct_matrix(n_mfcc, n_mels).T @ mel_db).astype(np.float32)


def wav_to_mfcc_map(
    path: str,
    sample_rate: int = 16000,
    max_length_s: float = 3.0,
    n_mfcc: int = 40,
) -> np.ndarray:
    """Reference audio pipeline minus the time-mean (dataset_luma.py:238-283):
    decode -> resample -> mono -> pad/trim -> MFCC, (n_mfcc, frames).

    The full time-frequency map feeds ``AudioEncoder(use_2d=True)``'s
    2D-spectrogram conv branch (reference classifiers.py:155-217, which has
    no producer in the reference — its dataset always time-averages)."""
    wav, rate = read_wav(path)
    if rate != sample_rate:
        wav = resample(wav, rate, sample_rate)
    mono = wav.mean(axis=0) if wav.shape[0] > 1 else wav[0]
    target = int(max_length_s * sample_rate)
    if len(mono) > target:
        mono = mono[:target]
    elif len(mono) < target:
        mono = np.pad(mono, (0, target - len(mono)))
    return mfcc(mono, sample_rate=sample_rate, n_mfcc=n_mfcc)


def wav_to_mfcc_mean(
    path: str,
    sample_rate: int = 16000,
    max_length_s: float = 3.0,
    n_mfcc: int = 40,
) -> np.ndarray:
    """Full reference audio pipeline (dataset_luma.py:238-295):
    decode -> resample -> mono -> pad/trim -> MFCC -> time-mean, (n_mfcc,)."""
    return wav_to_mfcc_map(
        path, sample_rate=sample_rate, max_length_s=max_length_s, n_mfcc=n_mfcc
    ).mean(axis=1)
