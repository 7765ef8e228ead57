"""Host-side corpora with on-the-fly noise mixing (counterpart of
``speech_enhancement_by_s3prl_tpu/data/datasets.py``), numpy only.

``OnlineDataset`` mixes clean speech and noise at a sampled SNR and returns
the (time, 3) channel stack (noisy, clean, scaled noise). Determinism: file
order, the noise file of each index and its SNR are frozen by seed 0 at
construction; ``infinite=True`` draws noise and SNR afresh per access, from
the per-item stream the loader installs. ``pseudo_modes`` draws one of the
active sampler's four cases per item from that stream and puts pseudo-clean
speech or pseudo noise (waveforms the Runner makes with the two upstreams) in
place of the real ones. ``NoisyCleanDataset`` reads paired clean and noisy
corpora. Every draw is the JAX package's, in its order, so an item has the
same bits in both packages.
"""
from __future__ import annotations

import copy
import glob as globlib
import os
import random
import re
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .audio_io import load_audio

# Per-item random stream. The loader derives one seed per item in the main
# thread, from the global random module (so reseeding it still governs every
# draw), and installs a thread-local stream around each __getitem__; direct
# dataset[i] access falls back to the global module.
_item_rng = threading.local()


def set_item_seed(seed: Optional[int]) -> None:
    _item_rng.rng = None if seed is None else random.Random(seed)


def item_random():
    return getattr(_item_rng, "rng", None) or random


AUDIO_EXTS = (".wav", ".flac", ".ogg", ".mp3", ".aif", ".aifc", ".aiff")


def find_audio_files(root: str) -> List[str]:
    out = []
    for dirpath, _, names in os.walk(root):
        for name in names:
            if os.path.splitext(name)[1].lower() in AUDIO_EXTS:
                out.append(os.path.join(dirpath, name))
    return sorted(out)


def filestrs2list(
    filestrs, fileroot: Optional[str] = None, sample_num: int = 0,
    select_sampled: bool = False, **kwargs,
) -> List[str]:
    """Resolve dir / list-file / glob specs into a deterministic file list:
    sorted union, seed-0 shuffle, then either the first `sample_num` files
    (select_sampled) or the rest."""
    if not isinstance(filestrs, (list, tuple)):
        filestrs = [filestrs]

    all_files: List[str] = []
    for filestr in filestrs:
        if os.path.isdir(filestr):
            all_files += find_audio_files(filestr)
        elif os.path.isfile(filestr):
            with open(filestr) as handle:
                all_files += sorted(
                    f"{fileroot}/{line.rstrip()}" for line in handle if line.strip()
                )
        else:
            all_files += sorted(globlib.glob(filestr))

    all_files = sorted(all_files)
    rng = random.Random(0)
    rng.shuffle(all_files)
    return all_files[:sample_num] if select_sampled else all_files[sample_num:]


def add_noise_np(
    speech: np.ndarray, noise: np.ndarray, snr: float, eps: float = 1e-10
) -> Tuple[np.ndarray, np.ndarray]:
    """SNR-scaled mixing of 1-D signals; noise is looped or truncated to the
    speech length first."""
    t = speech.shape[-1]
    if t >= noise.shape[-1]:
        reps = -(-t // noise.shape[-1])
        noise = np.tile(noise, reps)[:t]
    else:
        noise = noise[:t]

    snr_exp = 10.0 ** (snr / 10.0)
    speech_power = float(np.sum(speech**2))
    noise_power = float(np.sum(noise**2))
    scalar = (speech_power / (snr_exp * noise_power + eps)) ** 0.5
    scaled_noise = (scalar * noise).astype(np.float32)
    noisy = speech + scaled_noise
    if not np.isfinite(noisy).all():
        raise ValueError("non-finite values after noise mixing")
    return noisy, scaled_noise


def normalize_wav_decibel_np(
    audio: np.ndarray, target_level: float, eps: float = 1e-10
) -> np.ndarray:
    rms = float(np.sqrt(np.mean(audio**2)))
    return (audio * ((10.0 ** (target_level / 20.0)) / (rms + eps))).astype(np.float32)


class PseudoDataset:
    """Synthetic random corpus shaped like real data, for smoke tests."""

    def __init__(self, n: int = 1000, time: int = 16000, channels: int = 2, seed=0):
        self.data = np.random.default_rng(seed).standard_normal(
            (n, time, channels), dtype=np.float32
        )

    def __getitem__(self, idx):
        return self.data[idx]

    def __len__(self):
        return len(self.data)

    def collate_fn(self, samples, pad_to: Optional[int] = None):
        return pad_collate(samples, pad_to=pad_to)


def pad_collate(samples, pad_to: Optional[int] = None):
    """Pad variable-length (time, C) samples into (B, C, T) + lengths.
    `pad_to` rounds T up to a multiple of it (a duration bucket)."""
    has_case = isinstance(samples[0], tuple)
    if has_case:
        wavs = [s[0] for s in samples]
        cases = np.asarray([s[1] for s in samples], dtype=np.int64)
    else:
        wavs = list(samples)

    lengths = np.asarray([w.shape[0] for w in wavs], dtype=np.int64)
    max_len = int(lengths.max())
    if pad_to is not None:
        max_len = -(-max_len // pad_to) * pad_to
    n_ch = wavs[0].shape[1]
    out = np.zeros((len(wavs), n_ch, max_len), dtype=np.float32)
    for i, w in enumerate(wavs):
        out[i, :, : w.shape[0]] = w.T
    if has_case:
        return lengths, out, cases
    return lengths, out


class OnlineDataset:
    """Clean speech + noise corpora mixed on the fly at a sampled SNR.

    `half_noise` gives train/test disjoint noise halves ('front'/'end').
    `pseudo_modes` makes an item ``(wavs, case)``, the case drawn from the
    list: 0 = real speech + pseudo noise, 1 = real speech + real noise, 2 =
    pseudo clean + real noise, 3 = pseudo clean + pseudo noise; a pseudo
    source is a random pick of `pseudo_clean` / `pseudo_noise` (lists of 1-D
    waveforms), the real one when that list is None."""

    def __init__(
        self, speech: dict, noise: dict, sample_rate: int = 16000,
        max_time: int = 10000, min_time: int = 0, target_level: float = -25,
        snrs: Sequence[float] = (3,), infinite: bool = False,
        half_noise: Optional[str] = None, pseudo_modes: Optional[List[int]] = None,
        pseudo_clean=None, pseudo_noise=None, seed: int = 0, eps: float = 1e-8,
        **kwargs,
    ):
        self.sample_rate = sample_rate
        self.max_time = max_time
        self.min_time = min_time
        self.target_level = target_level
        self.infinite = infinite
        self.half_noise = half_noise
        self.pseudo_modes = list(pseudo_modes) if pseudo_modes is not None else None
        self.pseudo_clean = pseudo_clean
        self.pseudo_noise = pseudo_noise
        self.eps = eps

        self.filepths = filestrs2list(**speech)
        self.all_noises = filestrs2list(**noise)
        if not self.filepths:
            raise ValueError("no speech files resolved")
        if not self.all_noises:
            raise ValueError("no noise files resolved")
        self.all_snrs = list(snrs)

        fixed_rng = random.Random(0)
        self.fixed_noises = fixed_rng.choices(self.all_noises, k=len(self.filepths))
        fixed_rng = random.Random(0)
        self.fixed_snrs = fixed_rng.choices(self.all_snrs, k=len(self.filepths))

        # id_mapping decides how many datapoints exist
        self.id_mapping = list(range(len(self.filepths)))

    # -- loading --------------------------------------------------------
    def load_data(self, path: str) -> np.ndarray:
        wav, sr = load_audio(path, sr=self.sample_rate)
        maxpoints = (sr // 1000) * self.max_time
        minpoints = (sr // 1000) * self.min_time
        if len(wav) < minpoints:
            times = minpoints // len(wav) + 1
            wav = np.tile(wav, times)
        if len(wav) > maxpoints:
            wav = wav[:maxpoints]
        return wav.astype(np.float32)

    def _normalize(self, wav: np.ndarray) -> np.ndarray:
        return normalize_wav_decibel_np(wav, self.target_level)

    def __getitem__(self, idx):
        idx = self.id_mapping[idx]
        rng = item_random()
        case = rng.choice(self.pseudo_modes) if self.pseudo_modes is not None else None

        if case in (2, 3) and self.pseudo_clean is not None:
            speech = np.asarray(rng.choice(self.pseudo_clean), dtype=np.float32)
        else:
            speech = self.load_data(self.filepths[idx])
        speech = self._normalize(speech)

        # the noise file is drawn even when pseudo noise replaces it, as the
        # JAX package draws it, so the stream stays in step
        noise_pth = (
            rng.choice(self.all_noises) if self.infinite
            else self.fixed_noises[idx]
        )
        if case in (0, 3) and self.pseudo_noise is not None:
            noise = np.asarray(rng.choice(self.pseudo_noise), dtype=np.float32)
        else:
            noise = self.load_data(noise_pth)
        if self.half_noise:
            middle = len(noise) // 2
            noise = noise[:middle] if self.half_noise == "front" else noise[middle:]
        noise = self._normalize(noise)

        snr = rng.choice(self.all_snrs) if self.infinite else self.fixed_snrs[idx]
        noisy, scaled_noise = add_noise_np(speech, noise, snr, self.eps)
        wavs = np.stack([noisy, speech, scaled_noise], axis=-1)  # (time, 3)
        return wavs if case is None else (wavs, case)

    def __len__(self):
        return len(self.id_mapping)

    def collate_fn(self, samples, pad_to: Optional[int] = None):
        return pad_collate(samples, pad_to=pad_to)

    def get_subset(self, n_file: int = 100) -> "OnlineDataset":
        """Deterministic fixed subset (the runner's subtrain split)."""
        subset = copy.copy(self)
        subset.infinite = False
        mapping = list(subset.id_mapping)
        random.Random(0).shuffle(mapping)
        subset.id_mapping = mapping[:n_file]
        return subset


class NoisyCleanDataset:
    """Paired clean / noisy corpora matched by a file-id regex. Each root
    holds ``clean/`` and ``noisy/`` subdirectories; a pair shares a
    ``fileid_\\d+`` token. The clean files are a seeded sample (``seed``
    1227, ``sample_ratio``) or its complement; an utterance longer than
    ``max_sec`` gets one random crop, the same for both files, from the
    per-item stream. Items are (time, 2), channels (noisy, clean)."""

    def __init__(
        self, roots: Sequence[str], noisy_channel: int = 0, clean_channel: int = 1,
        seed: int = 1227, sample_ratio: float = 1.0, select_sampled: bool = True,
        sample_num: Optional[int] = None, regex: str = r"fileid_\d+",
        max_sec: float = 10.0, **kwargs,
    ):
        rng = random.Random(seed)
        clean_pths: List[str] = []
        for root in roots:
            clean_pths.extend(find_audio_files(os.path.join(root, "clean")))
        clean_pths = sorted(clean_pths)

        sampled = rng.sample(clean_pths, round(len(clean_pths) * sample_ratio))
        if select_sampled:
            self.clean_pths = sampled
        else:
            chosen = set(sampled)
            self.clean_pths = [p for p in clean_pths if p not in chosen]
        if not self.clean_pths:
            raise ValueError("no clean files resolved")

        if sample_num is not None:
            if len(self.clean_pths) >= sample_num:
                self.clean_pths = self.clean_pths[:sample_num]
            else:
                times = sample_num // len(self.clean_pths) + 1
                self.clean_pths = (self.clean_pths * times)[:sample_num]

        self.noisy_channel = noisy_channel
        self.clean_channel = clean_channel
        self.regex_searcher = re.compile(regex)
        self.max_sec = max_sec

    def _find_noisy(self, clean_pth: str) -> str:
        """The one file of the sibling ``noisy/`` directory with the clean
        file's id followed by a non-digit."""
        result = self.regex_searcher.search(clean_pth)
        if result is None:
            raise ValueError(f"no file-id in {clean_pth}")
        fileid = result.group()
        head, tail = os.path.split(os.path.dirname(clean_pth))
        noisy_dir = os.path.join(head, tail.replace("clean", "noisy"))
        exact = re.compile(re.escape(fileid) + r"\D")
        candidates = [p for p in globlib.glob(f"{noisy_dir}/*{fileid}*")
                      if exact.search(p) is not None]
        if len(candidates) != 1:
            raise ValueError(f"ambiguous noisy match for {clean_pth}: {candidates}")
        return candidates[0]

    def __getitem__(self, idx):
        clean_pth = self.clean_pths[idx]
        noisy_pth = self._find_noisy(clean_pth)
        clean, sr1 = load_audio(clean_pth, sr=None)
        noisy, sr2 = load_audio(noisy_pth, sr=None)
        if sr1 != sr2:
            raise ValueError(f"sample-rate mismatch: {clean_pth} vs {noisy_pth}")
        if clean.shape[-1] != noisy.shape[-1]:
            raise ValueError(f"length mismatch in pair {clean_pth}, {noisy_pth}")

        max_length = round(self.max_sec * sr1)
        if clean.shape[-1] > max_length:
            start = item_random().randint(0, clean.shape[-1] - max_length - 1)
            clean = clean[start : start + max_length]
            noisy = noisy[start : start + max_length]
        return np.stack([noisy, clean], axis=-1).astype(np.float32)  # (time, 2)

    def __len__(self):
        return len(self.clean_pths)

    def collate_fn(self, samples, pad_to: Optional[int] = None):
        return pad_collate(samples, pad_to=pad_to)

    def get_subset(self, ratio: float = 0.2, sample_seed=None) -> "NoisyCleanDataset":
        """The first ``ratio`` of the sorted files, or a seeded sample of
        them."""
        subset = copy.copy(self)
        clean_pths = sorted(subset.clean_pths)
        n = round(len(clean_pths) * ratio)
        if sample_seed is None:
            subset.clean_pths = clean_pths[:n]
        else:
            subset.clean_pths = random.Random(sample_seed).sample(clean_pths, n)
        return subset


DATASET_REGISTRY = {
    "OnlineDataset": OnlineDataset,
    "NoisyCleanDataset": NoisyCleanDataset,
    "PseudoDataset": PseudoDataset,
}
