"""Seeded speech-like audio and noisy mixtures.

No recording ships with the repository, yet training, enhancement, serving
and their checks need speech, noise and mixtures of the two.  This module
makes them from a seed, beside ``runtime/grid.synth_noise``'s six noise
categories:

  * speech: a voiced source (impulse train under a pitch contour, glottal
    roll-off), a cascade of three formant resonators whose targets move
    from vowel to vowel, a syllable-rate envelope, fricative bursts and
    pauses between phrases;
  * noise: ``grid.synth_noise``;
  * noisy clips: a noise-only lead-in (what the engine's ``init_n_len``
    seeding expects of a recording) followed by speech mixed at a seeded
    SNR.

The same seed gives the same samples on every machine.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import lfilter

from se_snmf_nat_tpu.runtime.grid import NOISE_TYPES, synth_noise

# vowel formant targets (F1, F2, F3) in Hz: Peterson & Barney's adult
# averages for /a i e u o ae uh er/
_VOWELS = np.array([[730, 1090, 2440], [270, 2290, 3010], [530, 1840, 2480],
                    [300, 870, 2240], [570, 840, 2410], [660, 1720, 2410],
                    [520, 1190, 2390], [490, 1350, 1690]], np.float64)
_BANDWIDTHS = np.array([80.0, 100.0, 140.0])
_SPEECH_RMS = 2500.0     # int16 scale of CHiME close-talk speech
_BLOCK = 160             # formant update interval (10 ms at 16 kHz)


def _smooth_walk(n: int, rng: np.random.Generator, a: float) -> np.ndarray:
    """Unit-variance low-passed noise (one-pole, coefficient ``a``)."""
    w = lfilter([1.0 - a], [1.0, -a], rng.standard_normal(n))
    return w / (np.std(w) + 1e-12)


def _syllable_plan(n: int, fs: int, rng: np.random.Generator):
    """(start, length, vowel, fricative) per syllable, with phrase pauses."""
    plan, pos = [], int(rng.uniform(0.0, 0.1) * fs)
    while pos < n:
        for _ in range(int(rng.integers(2, 7))):          # one phrase
            length = int(rng.uniform(0.12, 0.30) * fs)
            if pos + length > n:
                return plan
            plan.append((pos, length, int(rng.integers(len(_VOWELS))),
                         bool(rng.random() < 0.35)))
            pos += length + int(rng.uniform(0.0, 0.05) * fs)
        pos += int(rng.uniform(0.15, 0.45) * fs)          # pause
    return plan


def synth_speech(n: int, fs: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` samples of speech-like audio at int16 scale (float64)."""
    t = np.arange(n) / fs
    # pitch: a speaker's mean, a slow declination per phrase-length cycle
    # and a wandering component
    f0 = rng.uniform(95.0, 210.0) * (
        1.0 + 0.10 * np.sin(2 * np.pi * rng.uniform(0.3, 0.7) * t
                            + rng.uniform(0, 2 * np.pi))
        + 0.05 * _smooth_walk(n, rng, 0.9995))
    cycles = np.cumsum(f0) / fs
    pulses = np.diff(np.floor(cycles), prepend=0.0)       # one per period
    voiced = lfilter([1.0], [1.0, -0.97], pulses)         # glottal roll-off
    voiced = lfilter([1.0], [1.0, -0.9], voiced)
    voiced = np.diff(voiced, prepend=0.0)                 # lip radiation

    plan = _syllable_plan(n, fs, rng)
    env = np.zeros(n)
    fric = np.zeros(n)
    # formant tracks: hold each syllable's vowel, glide to the next
    track = np.empty((n // _BLOCK + 1, 3))
    track[:] = _VOWELS[int(rng.integers(len(_VOWELS)))]
    for k, (start, length, vowel, has_fric) in enumerate(plan):
        end = start + length
        env[start:end] = np.sin(np.pi * np.arange(length) / length) ** 0.7
        b0, b1 = start // _BLOCK, min(end // _BLOCK + 1, len(track))
        nxt = plan[k + 1][2] if k + 1 < len(plan) else vowel
        ramp = np.linspace(0.0, 1.0, b1 - b0)[:, None] ** 3
        track[b0:b1] = (_VOWELS[vowel] * (1 - ramp)
                        + _VOWELS[nxt] * ramp)
        track[b1:] = _VOWELS[nxt]
        if has_fric:
            m = min(int(rng.uniform(0.04, 0.08) * fs), length)
            burst = np.diff(rng.standard_normal(m + 1))   # high-pass
            fric[start:start + m] += burst * np.hanning(m) * 0.6

    y = np.zeros(n)
    zi = [np.zeros(2) for _ in range(3)]
    src = voiced * env
    for b in range(0, n, _BLOCK):
        seg = src[b:b + _BLOCK]
        for j in range(3):
            r = np.exp(-np.pi * _BANDWIDTHS[j] / fs)
            theta = 2 * np.pi * track[b // _BLOCK, j] / fs
            a = [1.0, -2 * r * np.cos(theta), r * r]
            seg, zi[j] = lfilter([1.0 - r], a, seg, zi=zi[j])
        y[b:b + _BLOCK] = seg
    active = env > 0
    if not active.any():                  # shorter than one syllable
        return np.zeros(n)
    y = y / (np.std(y[active]) + 1e-12) + fric
    return y * (_SPEECH_RMS / np.sqrt(np.mean(y[active] ** 2)))


def mix_at_snr(speech: np.ndarray, noise: np.ndarray, snr_db: float,
               lead: int = 0) -> np.ndarray:
    """``noise`` scaled so that speech over noise is ``snr_db`` across the
    speech part, with ``speech`` added after ``lead`` noise-only samples."""
    seg = noise[lead:lead + len(speech)]
    s_rms = np.sqrt(np.mean(speech ** 2)) + 1e-12
    n_rms = np.sqrt(np.mean(seg ** 2)) + 1e-12
    mix = noise[:lead + len(speech)] * (s_rms / (n_rms * 10 ** (snr_db / 20)))
    mix[lead:] += speech
    return mix


def noisy_clip(rng: np.random.Generator, seconds: float, fs: int = 16000,
               snr_db: float | None = None, kind: str | None = None,
               lead_s: float = 0.5) -> tuple[np.ndarray, np.ndarray]:
    """One seeded noisy clip at int16 scale: (noisy int16, clean float64).

    ``snr_db`` defaults to a draw from [0, 15] dB and ``kind`` to a draw
    from ``grid.NOISE_TYPES``; the clean speech starts after ``lead_s``
    seconds of noise only."""
    n = int(seconds * fs)
    lead = int(lead_s * fs)
    speech = synth_speech(n - lead, fs, rng)
    kind = kind or NOISE_TYPES[int(rng.integers(len(NOISE_TYPES)))]
    snr = float(rng.uniform(0.0, 15.0)) if snr_db is None else snr_db
    noise = synth_noise(kind, n, fs, rng, speech=speech, variant=1.0)
    mix = mix_at_snr(speech, noise, snr, lead)
    clean = np.concatenate([np.zeros(lead), speech])
    return np.clip(np.rint(mix), -32768, 32767).astype(np.int16), clean


def noisy_clips(seed: int, count: int, min_s: float, max_s: float,
                fs: int = 16000) -> list[np.ndarray]:
    """``count`` seeded noisy int16 clips with lengths drawn uniformly from
    [min_s, max_s] seconds, noise types and SNRs drawn per clip."""
    rng = np.random.default_rng(seed)
    return [noisy_clip(rng, float(rng.uniform(min_s, max_s)), fs)[0]
            for _ in range(count)]
