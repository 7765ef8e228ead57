"""Train and eval steps (counterpart of
``speech_enhancement_by_s3prl_tpu/runner/trainer.py``).

Three modes pick what the head reads: ``from_rawfeature`` (the downstream
features), ``from_waveform`` (the upstream-input features, which a head such
as ``Mockingjay`` encodes itself) and, with neither, the upstream mode (the
hidden states of a frozen upstream over the upstream-input features). The
upstream's parameters are never in the gradient; it runs in train mode, its
dropout live, only when it is ``trainable`` (a ``--dropout`` override) and
the head is training.

Dropout masks come from salts (``models/transformer.SaltStream``) drawn on
the host from (``seed``, the step) for each train step, so a resumed run
draws the masks the uninterrupted run would have drawn, and no value is read
back from the device.

The train step runs the six-feature context, the upstream, the head, the
objective and its backward, the global-norm clip, the optimizer update and
the non-finite guard, eagerly on the device of the batch. The guard keeps the JAX package's
semantics without reading a value back to the host: the new parameters and
optimizer state are selected with ``torch.where`` on the finiteness of the
gradient norm, so a skipped step leaves both (the optimizer's count
included) as they were, and the global step still advances. Parameters are
updated in place in the model: the port's state is the model's own tensors.

The eval step decodes with the noisy phase, renormalizes to the target
channel's level, and scores the objective and the metrics that have a
batched version (``eval_metrics``: sisdr, stoi, estoi, pesq_nb, pesq_wb) on
the device, in full f32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..metrics import batch_scores, check_metrics
from ..models.transformer import SaltStream
from ..ops.audio import length_masks, masked_normalize_decibel


@dataclasses.dataclass
class TrainState:
    """``params``: the model's parameters by ``state_dict`` name (the
    module's own tensors, updated in place); ``opt_state``: the optimizer's
    state dict; ``step``: the global step, a 0-d int32 tensor;
    ``host_step``: the same count on the host, which seeds the dropout
    salts."""

    params: Dict[str, torch.Tensor]
    opt_state: dict
    step: torch.Tensor
    host_step: int = 0


def make_context(
    preprocessor,
    wavs: torch.Tensor,
    lengths: torch.Tensor,
    channel_inp: int,
    channel_tar: int,
) -> Dict[str, torch.Tensor]:
    """Extract the six-feature bundle and assemble the objective context."""
    (
        feats_for_upstream,
        feats_for_downstream,
        linear_inp,
        phase_inp,
        linear_tar,
        phase_tar,
    ) = preprocessor(wavs)

    hop = preprocessor._win_args["hop_length"]
    stft_lengths = lengths // hop + 1
    stft_masks = length_masks(stft_lengths, linear_inp.shape[1])

    return {
        "wavs": wavs,
        "lengths": lengths,
        "feats_for_upstream": feats_for_upstream,
        "feats_for_downstream": feats_for_downstream,
        "linear_inp": linear_inp,
        "phase_inp": phase_inp,
        "linear_tar": linear_tar,
        "phase_tar": phase_tar,
        "stft_lengths": stft_lengths,
        "stft_length_masks": stft_masks,
        "wav_inp": wavs[:, channel_inp, :],
        "wav_tar": wavs[:, channel_tar, :],
    }


def decode_wav(preprocessor, predicted, phase_inp, lengths, max_len, target_level):
    """iSTFT + zero-pad (or cut) to max_len + renorm to target level.

    ``istft`` returns ``(n_frames - 1) * hop`` samples, which the pad or cut
    brings back to the input length."""
    wav = preprocessor.istft(predicted, phase_inp)
    pad = max_len - wav.shape[-1]
    wav = F.pad(wav, (0, pad)) if pad > 0 else wav[:, :max_len]
    masks = length_masks(lengths, max_len)
    return masked_normalize_decibel(wav, target_level, masks)


def _where_tree(ok, new, old):
    if isinstance(new, dict):
        return {k: _where_tree(ok, new[k], old[k]) for k in new}
    return torch.where(ok, new, old)


@dataclasses.dataclass
class StepBuilder:
    """The step functions over one preprocessor, head, objective and
    optimizer."""

    preprocessor: Any
    model: nn.Module
    objective: Any                  # callable(**ctx) -> (loss, aux)
    optimizer: Any                  # runner/optim.py: init / update
    upstream: Any = None            # models/upstream.py, on the model's device
    from_waveform: bool = False
    from_rawfeature: bool = True
    channel_inp: int = 0
    channel_tar: int = 1
    grad_clip: float = 1.0
    eval_metrics: Tuple[str, ...] = ("sisdr",)  # scored on the device
    sample_rate: int = 16000
    seed: int = 0                   # with the step, seeds the dropout salts

    def __post_init__(self):
        if not (self.from_rawfeature or self.from_waveform) and self.upstream is None:
            raise ValueError("the upstream mode (neither from_rawfeature nor "
                             "from_waveform) needs an upstream")
        check_metrics(self.eval_metrics)

    # -- shared forward ------------------------------------------------
    def _down_inp(self, ctx, train: bool, salts):
        if self.from_waveform:
            # the reference hands waveforms to a model that extracts its own
            # features; here the model receives the upstream-input features
            return ctx["feats_for_upstream"]
        if self.from_rawfeature:
            return ctx["feats_for_downstream"]
        up_train = bool(train and self.upstream.trainable)
        self.upstream.train(up_train)
        with torch.no_grad():
            return self.upstream(ctx["feats_for_upstream"], salts if up_train else None)

    def _forward(self, ctx, train: bool, salts=None):
        features = self._down_inp(ctx, train, salts)
        self.model.train(train)
        kwargs = {"salts": salts} if getattr(self.model, "takes_salts", False) else {}
        return self.model(features, ctx["linear_inp"], **kwargs)

    def loss_fn(self, ctx, salts=None):
        predicted, aux = self._forward(ctx, train=True, salts=salts)
        loss, obj_aux = self.objective(**{**ctx, "predicted": predicted, **aux})
        return loss, (predicted, aux, obj_aux)

    # -- train ----------------------------------------------------------
    def train_step(self, state: TrainState, wavs: torch.Tensor, lengths: torch.Tensor,
                   salts: Optional[SaltStream] = None):
        """One update. Returns (state, {'loss', 'grad_norm', 'skipped'}),
        the stats as device tensors (the caller reads them). ``salts``
        replaces the step's own ``SaltStream(seed, state.host_step)``."""
        ctx = make_context(
            self.preprocessor, wavs, lengths, self.channel_inp, self.channel_tar
        )
        if salts is None:
            salts = SaltStream(self.seed, state.host_step)
        names = list(state.params)
        with torch.enable_grad():
            loss, _ = self.loss_fn(ctx, salts)
            grads = torch.autograd.grad(loss, [state.params[k] for k in names])
        with torch.no_grad():
            grad_norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
            # the reference's global clip before the optimizer step
            scale = torch.clamp(self.grad_clip / (grad_norm + 1e-6), max=1.0)
            grads = {k: g * scale for k, g in zip(names, grads)}
            updates, new_opt = self.optimizer.update(grads, state.opt_state, state.params)
            # non-finite guard: skip the update, keep counting steps
            ok = torch.isfinite(grad_norm)
            for k, p in state.params.items():
                p.copy_(torch.where(ok, p + updates[k], p))
            new_state = TrainState(
                state.params, _where_tree(ok, new_opt, state.opt_state), state.step + 1,
                state.host_step + 1,
            )
        return new_state, {"loss": loss.detach(), "grad_norm": grad_norm, "skipped": ~ok}

    # -- eval -----------------------------------------------------------
    def decode_wav(self, predicted, phase_inp, lengths, max_len, target_level):
        return decode_wav(self.preprocessor, predicted, phase_inp, lengths, max_len,
                          target_level)

    @torch.inference_mode()
    def eval_step(self, wavs: torch.Tensor, lengths: torch.Tensor, wav_out: str = "full"):
        """Loss, scores and waveforms of one batch. wav_out='first' returns
        only utterance 0 of the noisy / clean / enhanced waveforms."""
        ctx = make_context(
            self.preprocessor, wavs, lengths, self.channel_inp, self.channel_tar
        )
        predicted, aux = self._forward(ctx, train=False)
        max_len = wavs.shape[-1]
        wav_predicted = self.decode_wav(
            predicted, ctx["phase_inp"], lengths, max_len, ctx["wav_tar"]
        )
        masks = length_masks(lengths, max_len)
        full_ctx = {
            **ctx,
            "predicted": predicted,
            **aux,
            "wav_predicted": wav_predicted,
            "length_masks": masks,
        }
        loss, _ = self.objective(**full_ctx)
        scores = batch_scores(
            self.eval_metrics, wav_predicted, ctx["wav_tar"], lengths, self.sample_rate
        )
        keep = (lambda w: w[:1]) if wav_out == "first" else (lambda w: w)
        return {
            "loss": loss,
            "scores": scores,
            "wav_predicted": keep(wav_predicted),
            "wav_inp": keep(ctx["wav_inp"]),
            "wav_tar": keep(ctx["wav_tar"]),
        }

    # -- state ----------------------------------------------------------
    def init_state(self) -> TrainState:
        """The model's current parameters, a fresh optimizer state and step 0."""
        params = dict(self.model.named_parameters())
        device = next(iter(params.values())).device
        return TrainState(params, self.optimizer.init(params),
                          torch.zeros((), dtype=torch.int32, device=device))
