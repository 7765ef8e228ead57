"""Media logging as files (the port's counterpart of the JAX package's
``SummaryWriter.add_audio`` / ``add_figure`` calls and its ``tb_logging``).

Each clip or image goes to ``expdir/media/step_<n>/<tag>``: audio as 16-bit
PCM WAV, images as greyscale PNG (``utils/plotting.py``). Each file is listed
in ``expdir/media.jsonl``, beside ``scalars.jsonl``, as one JSON object a
line: ``{"step", "tag", "kind", "path"}``, the path relative to ``expdir``
and the tag the JAX package's TensorBoard tag. A write that fails raises.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..data.audio_io import write_wav
from ..ops.features import get_feat_config
from ..utils.plotting import spectrogram_png


class MediaLog:
    """Writes media files under ``expdir``; ``media_logging`` computes a
    clip's spectrogram through ``preprocessor`` on ``device``."""

    def __init__(self, expdir: str, preprocessor, device):
        self.expdir = expdir
        self.preprocessor = preprocessor
        self.device = torch.device(device)
        self.index = os.path.join(expdir, "media.jsonl")

    def _write(self, step: int, tag: str, kind: str, ext: str, write) -> None:
        name = tag if tag.endswith(ext) else tag + ext
        rel = os.path.join("media", f"step_{int(step)}", name)
        path = os.path.join(self.expdir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write(path)
        with open(self.index, "a") as f:
            f.write(json.dumps({"step": int(step), "tag": tag, "kind": kind, "path": rel})
                    + "\n")

    def add_png(self, tag: str, png: bytes, step: int) -> None:
        def write(path):
            with open(path, "wb") as f:
                f.write(png)

        self._write(step, tag, "image", ".png", write)

    def media_logging(self, step: int, tag: str, data) -> None:
        """One clip: flattened (a batch becomes one clip), normalized by its
        peak, written as ``{tag}.wav``, and its log-linear spectrogram, made
        by the preprocessor on the device (kernel B4 on the card), written
        as ``{tag}.png``."""
        if isinstance(data, torch.Tensor):
            data = data.detach().cpu().numpy()
        data = np.asarray(data, np.float32).reshape(-1)
        peak = np.abs(data).max()
        if peak > 0:
            data = data / peak
        sample_rate = self.preprocessor.config.sample_rate
        self._write(step, f"{tag}.wav", "audio", ".wav",
                    lambda path: write_wav(path, data, sample_rate))
        with torch.no_grad():
            (linear,) = self.preprocessor(
                torch.from_numpy(data).reshape(1, 1, -1).to(self.device),
                [get_feat_config("linear", log=True)])
        self.add_png(f"{tag}.png", spectrogram_png(linear[0].cpu().numpy()), step)
