"""The flagship model, its enhance closure and its trainer (counterpart of
``__graft_entry__.py::_build`` and ``make_enhance``), and the Mockingjay
joint-finetune trainer (counterpart of ``bench.py``'s mockingjay mode).

Flagship: 40 log-mel bands with 2 deltas (120 dims) into a ``Residual``
head of 3 bidirectional LSTM layers of 256, a Dense 512 -> 201 and a
sigmoid mask on the noisy power spectrum; iSTFT with the noisy phase;
renorm to -25 dB. It trains with the SISDR objective, BertAdam(4e-5, 0.07,
20000), a global clip at 1.0 and SI-SDR as the eval metric.

Every builder takes ``compute_dtype`` ('f32' | 'bf16', as the JAX
``_build``): bf16 runs the head's projections and W_hh^T (and, for a
one-direction head, h in the step product: the JAX scan cell), or the
Mockingjay encoder's products, in bf16 (``models/lstm.py``,
``models/transformer.py``); parameters and optimizer state stay f32.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import use_full_fp32
from .models.heads import build_head
from .models.spec_head import Mockingjay
from .models.transformer import TransformerConfig
from .objectives import build_objective
from .ops.features import OnlinePreprocessor, get_feat_config
from .runner.optim import build_optimizer
from .runner.trainer import StepBuilder, decode_wav, make_context

TARGET_LEVEL = -25.0


def flagship_settings(hidden_size=256, num_layers=3, bidirectional=True, delta=2,
                      compute_dtype="f32"):
    """(config, paras) a checkpoint of the flagship records, in the keys
    ``serve.build_raw_enhancer`` reads to rebuild it."""
    config = {
        "preprocessor": {
            "baseline": get_feat_config("mel", 0, log=True, delta=delta, cmvn=False)
        },
        "model": {
            "Residual": {
                "hidden_size": hidden_size, "num_layers": num_layers,
                "bidirectional": bidirectional, "activation": "Sigmoid",
                "cmvn": False,
            }
        },
    }
    paras = {"downstream": "Residual", "from_rawfeature": True,
             "compute_dtype": compute_dtype}
    return config, paras


def _preprocessor(n_mels=40, delta=2) -> OnlinePreprocessor:
    """The six features: the upstream input (log-mel + 1 delta, CMVN), the
    downstream input (log-mel + ``delta`` deltas), and the linear spectrum
    and phase carrier of channels 0 and 1."""
    return OnlinePreprocessor(n_mels=n_mels, feat_list=[
        get_feat_config("mel", 0, log=True, delta=1, cmvn=True),
        get_feat_config("mel", 0, log=True, delta=delta, cmvn=False),
        get_feat_config("linear", 0),
        get_feat_config("uphase", 0),
        get_feat_config("linear", 1),
        get_feat_config("uphase", 1),
    ])


def build(hidden_size=256, num_layers=3, bidirectional=True, n_mels=40, delta=2,
          compute_dtype="f32", *, device, generator=None):
    """(preprocessor, model) of the flagship, the model on ``device`` with
    weights drawn from ``generator``."""
    use_full_fp32()
    pre = _preprocessor(n_mels, delta)
    model = build_head(
        "Residual", input_size=pre.feat_dims()[1], output_size=201,
        generator=generator, hidden_size=hidden_size, num_layers=num_layers,
        bidirectional=bidirectional, activation="Sigmoid", cmvn=False,
        compute_dtype=compute_dtype,
    )
    return pre, model.eval().to(device)


def build_train(hidden_size=256, num_layers=3, bidirectional=True, n_mels=40,
                delta=2, compute_dtype="f32", *, device, generator=None) -> StepBuilder:
    """The flagship's ``StepBuilder`` for training, the model on ``device``
    with weights drawn from ``generator``."""
    pre, model = build(hidden_size, num_layers, bidirectional, n_mels, delta, compute_dtype,
                       device=device, generator=generator)
    return StepBuilder(
        preprocessor=pre,
        model=model,
        objective=build_objective("SISDR"),
        optimizer=build_optimizer("BertAdam", 4e-5, 0.07, 20000),
        from_rawfeature=True,
        grad_clip=1.0,
        eval_metrics=("sisdr",),
    )


def build_mockingjay_train(config: Optional[TransformerConfig] = None,
                          compute_dtype="f32", *, device, generator=None,
                          seed: int = 0) -> StepBuilder:
    """The Mockingjay joint finetune's ``StepBuilder``: the whole TERA
    encoder (``config``, by default the full 6 x 768 x 12, FFN 3072, dropout
    0.1) and its spec head, trained from the upstream-input features (80-d
    log-mel + delta) with SISDR and BertAdam(4e-5, 0.07, 20000); the model
    on ``device`` with weights drawn from ``generator``, dropout salts from
    ``seed``."""
    use_full_fp32()
    pre = _preprocessor(delta=1)
    config = config or TransformerConfig(input_dim=pre.feat_dims()[0])
    model = Mockingjay(input_size=pre.feat_dims()[0], output_size=201, config=config,
                       compute_dtype=compute_dtype, generator=generator)
    return StepBuilder(
        preprocessor=pre,
        model=model.to(device),
        objective=build_objective("SISDR"),
        optimizer=build_optimizer("BertAdam", 4e-5, 0.07, 20000),
        from_waveform=True,
        from_rawfeature=False,
        grad_clip=1.0,
        eval_metrics=("sisdr",),
        seed=seed,
    )


def make_enhance(preprocessor, model):
    """``enhance(wavs (B, 3, T), lengths (B,)) -> (B, T)`` on the device of
    the inputs: features, head, iSTFT with the noisy phase, renorm."""

    @torch.inference_mode()
    def enhance(wavs, lengths):
        ctx = make_context(preprocessor, wavs, lengths, 0, 1)
        predicted, _ = model(ctx["feats_for_downstream"], ctx["linear_inp"])
        return decode_wav(preprocessor, predicted, ctx["phase_inp"], lengths,
                          wavs.shape[-1], TARGET_LEVEL)

    return enhance
