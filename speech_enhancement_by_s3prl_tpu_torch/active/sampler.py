"""Active-learning sampler (counterpart of
``speech_enhancement_by_s3prl_tpu/active/sampler.py``).

Candidate utterances are scored by per-sample gradient embeddings,
cosine-matched against the mean embedding of a pseudo-target "query" batch,
and kept when the match is above 0, into four per-case buffers the trainer
draws from.

An embedding is the gradient of the training loss over the head's parameters
(or over one LSTM layer's, ``active_layerid``), flattened in the JAX package's
leaf order: the flax parameter paths sorted, as ``jax.tree.leaves`` walks the
tree, the LSTM weights in torch layout and a Dense kernel as (in, out). The
two packages' embeddings are therefore comparable coordinate for coordinate.

Per-sample engines (``impl``):

- ``"vmap"`` (the default, the engine the Runner uses): row i's embedding is
  the gradient of the loss of row i alone at the batch's padded length, the
  JAX package's ``vmap(grad)`` engine. For ``LSTM``, ``Residual``, ``Linear``
  and ``LinearResidual`` heads the batch runs one forward that records the
  captured streams (``models/lstm.py``), the objective is applied to each row
  alone, the rows' losses are summed, and ONE batched backward (kernel B2 bwd
  on the card) gives every row's gate cotangents: rows do not interact before
  the objective's batch reduction, so row i's cotangent is exactly the
  gradient of loss i. The per-sample gradients are then outer-product sums
  over time of the captured streams; in a bf16 head those of W_ih (from the
  input rounded to bf16) and W_hh are rounded to bf16, as JAX's per-sample
  gradients come back through its bf16 casts. Any other head takes one
  backward per utterance through the same kernels, and so does a
  one-direction ``LSTM`` / ``Residual`` head in bf16: its per-row dW_hh is a
  sum rounded to bf16 step by step (the JAX scan cell's), which no outer
  product of the streams gives.
- ``"capture"``: the gradient of the BATCH loss, one batched backward,
  assembled per sample the same way: the JAX package's capture engine, equal
  to ``"vmap"`` up to a positive per-sample scale (the objective's batch
  reduction weight), which the cosine matching cancels. It takes a
  bidirectional ``LSTM`` / ``Residual`` head; for any other it warns and
  runs ``"vmap"``, as the JAX package does. In bf16 it rounds nothing, as
  JAX's capture engine builds its f32 sums from the unrounded captured
  input.

The scoring runs with TF32 off (``metrics.full_f32``): the match scores are
cosines of million-coordinate embeddings, and which candidates pass ``> 0``
must not move with the contraction's precision.

``AsyncSampler`` scores on a host thread, on a CUDA stream of its own, a
snapshot of the head taken at ``start()``.
"""
from __future__ import annotations

import contextlib
import copy
import threading
import warnings
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..metrics import full_f32
from ..models.convert import flax_path
from ..models.lstm import Capture
from ..models.transformer import SaltStream
from ..ops.stft import magphase, stft
from ..runner.trainer import make_context
from ..utils import prng

ACTIVE_BUFFER_NUM = 4
# the Dense of each capturing head: its streams' prefix -> its parameters'
DENSE_OF = {"scaling": "scaling_layer", "linear": "linear"}


def _path(params: Dict[str, torch.Tensor], name: str) -> str:
    return "/".join(flax_path(name, params[name].dim()))


def _select_layer(params: Dict[str, torch.Tensor], layerid: Optional[int]):
    """The parameters of LSTM layer ``layerid`` (both directions), or all of
    them for None: those whose flax path holds ``l{layerid}_``."""
    if layerid is None:
        return dict(params)
    return {name: p for name, p in params.items() if f"l{layerid}_" in _path(params, name)}


def _leaf_order(params: Dict[str, torch.Tensor]) -> List[str]:
    """The names in the JAX package's leaf order: by flax path."""
    return sorted(params, key=lambda n: flax_path(n, params[n].dim()))


def _flat(names: List[str], grads) -> torch.Tensor:
    """Gradients flattened in order into one vector, each in its flax
    leaf's layout: a 2-D ``.weight`` (a Dense kernel) as (in, out)."""
    return torch.cat([(g.T if n.endswith(".weight") and g.dim() == 2 else g).reshape(-1)
                      for n, g in zip(names, grads)])


def _capture_supported(model, layerid: Optional[int]) -> bool:
    """The capture engine needs a bidirectional ``LSTM`` / ``Residual`` head:
    one layer for an explicit ``layerid``, the whole head (every LSTM layer
    and the scaling Dense) for None."""
    from ..models.heads import LSTM, Residual

    if not (isinstance(model, (LSTM, Residual)) and bool(model.lstm.bidirectional)):
        return False
    return layerid is None or 0 <= layerid < model.lstm.num_layers


def _captures(model) -> bool:
    """Whether the per-row gradients of all the head's parameters are
    outer-product sums of the streams it records: not those of a
    one-direction LSTM stack in bf16, whose dW_hh is rounded step by step."""
    from ..models.heads import LSTM, Linear, LinearResidual, Residual

    if isinstance(model, (LSTM, Residual)):
        return bool(model.lstm.bidirectional) or model.compute_dtype == torch.float32
    return isinstance(model, (Linear, LinearResidual))


def _lstm_layer_grads(streams, cots, layer: int, bf16: bool = False) -> Dict[str, torch.Tensor]:
    """Per-sample gradients of one LSTM layer from its captured streams, by
    parameter name, each with a leading batch axis. torch layout: w_ih (4H,
    D), w_hh (4H, H); the gradients are sum_t d_t (x) x_t and sum_t d_t (x)
    h_{t-1}, and both biases sum_t d_t (the gates are xw + b_ih + b_hh + h
    W_hh^T, all additive). Direction 1 runs time-flipped, so h_{t-1} is the
    previous step of its own stream. ``bf16``: each row's gradient as it
    comes back through a bidirectional bf16 layer's casts: x_t rounded to
    bf16 in W_ih's sum, W_ih's and W_hh's sums rounded to bf16, the biases
    f32."""
    xs = streams[f"l{layer}_xs"].detach()          # (dirs, B, T, D)
    hs = streams[f"l{layer}_hs"].detach()          # (dirs, B, T, H)
    d = cots[f"l{layer}_xw"]                       # (dirs, B, T, 4H)
    h_prev = torch.cat([torch.zeros_like(hs[:, :, :1]), hs[:, :, :-1]], dim=2)
    if bf16:
        xs = xs.to(torch.bfloat16).float()
    # batched products over (direction, row): no per-step outer product
    g_wih = torch.einsum("dbtg,dbtn->dbgn", d, xs)
    g_whh = torch.einsum("dbtg,dbtk->dbgk", d, h_prev)
    if bf16:
        g_wih, g_whh = (g.to(torch.bfloat16).float() for g in (g_wih, g_whh))
    g_b = d.sum(dim=2)
    out = {}
    for i, direction in enumerate(("fwd", "bwd")[: d.shape[0]]):
        p = f"lstm.l{layer}_{direction}."
        out.update({p + "w_ih": g_wih[i], p + "w_hh": g_whh[i], p + "b_ih": g_b[i],
                    p + "b_hh": g_b[i]})
    return out


def _dense_grads(streams, cots, dense: str) -> Dict[str, torch.Tensor]:
    """Per-sample gradients of a Dense from its input and output cotangent,
    the weight as the flax kernel (in, out)."""
    xs = streams[f"{dense}_xs"].detach()           # (B, T, D)
    d = cots[f"{dense}_xw"]                        # (B, T, O)
    prefix = DENSE_OF[dense]
    return {f"{prefix}.weight": torch.einsum("btd,bto->bdo", xs, d),
            f"{prefix}.bias": d.sum(dim=1)}


def make_scoring_fn(step_builder, active_layerid: Optional[int] = None,
                    impl: str = "vmap") -> Callable:
    """``scoring(model, wavs, lengths, mean=False, rng=None) -> (B or 1,
    P)``: the embeddings of a batch under ``model`` (the step builder's head,
    or a copy of it), on the model's device.

    ``mean=False``: one embedding per utterance by the ``impl`` engine;
    ``mean=True``: one gradient of the batch loss (the query side).

    The loss runs in train mode, as the trainer's: a dropout-bearing head
    (Mockingjay) or a live upstream is scored with its dropout live, from the
    key ``rng`` as the JAX sampler draws (omitted: ``PRNGKey(0)``, its
    default): the batch's forward keyed on ``rng`` (``mean=True`` and the
    capture engine), row i's on ``split(rng, B)[i]`` (the vmap engine). A bad
    ``active_layerid`` raises at the call."""
    sb = step_builder
    if impl not in ("vmap", "capture"):
        raise ValueError(f"unknown scoring impl {impl!r}")
    if impl == "capture" and not _capture_supported(sb.model, active_layerid):
        warnings.warn(
            f"impl='capture' is not supported for {type(sb.model).__name__} (needs a "
            f"bidirectional LSTM/Residual head; layerid={active_layerid!r}): using the "
            "vmap engine", stacklevel=2)
        impl = "vmap"

    def selected(model) -> List[str]:
        params = dict(model.named_parameters())
        sel = _select_layer(params, active_layerid)
        if not sel:
            raise ValueError(
                f"--active_layerid {active_layerid}: no parameter path contains "
                f"'l{active_layerid}_': the configured downstream has no such LSTM layer")
        return _leaf_order(sel)

    def forward(model, ctx, salts, capture=None, row_keys=None):
        """The head's outputs in train mode; with ``row_keys`` a live
        upstream runs row by row, row i from its own key, as under JAX's
        vmap."""
        if row_keys is not None and sb.upstream is not None and sb.upstream.trainable:
            feats = ctx["feats_for_upstream"]
            features = torch.cat([
                sb._down_inp({"feats_for_upstream": feats[i:i + 1]}, True, SaltStream(key=key))
                for i, key in enumerate(row_keys)])
        else:
            features = sb._down_inp(ctx, True, salts)
        model.train(True)
        kwargs = {"salts": salts} if getattr(model, "takes_salts", False) else {}
        if capture is not None:
            kwargs["capture"] = capture
        return model(features, ctx["linear_inp"], **kwargs)

    def objective(ctx, predicted, aux):
        loss, _ = sb.objective(**{**ctx, "predicted": predicted, **aux})
        return loss

    def context(wavs, lengths):
        return make_context(sb.preprocessor, wavs, lengths, sb.channel_inp, sb.channel_tar)

    def scoring_mean(model, wavs, lengths, rng):
        names = selected(model)
        params = dict(model.named_parameters())
        ctx = context(wavs, lengths)
        loss = objective(ctx, *forward(model, ctx, SaltStream(key=rng)))
        return _flat(names, torch.autograd.grad(loss, [params[n] for n in names]))[None]

    def scoring_captured(model, wavs, lengths, rng, per_row: bool):
        """The capture machinery: the batch loss (``per_row`` False) or the
        sum of the rows' own losses, one backward, the per-sample gradients
        from the captured streams (per row through a bf16 head's casts)."""
        names = selected(model)
        bf16_rows = per_row and getattr(model, "compute_dtype", None) == torch.bfloat16
        ctx = context(wavs, lengths)
        streams = Capture("all" if active_layerid is None else active_layerid)
        row_keys = prng.split(rng, wavs.shape[0]) if per_row else None
        predicted, aux = forward(model, ctx, SaltStream(key=rng), streams, row_keys)
        if per_row:
            # the objective of each row alone, as vmap over w[None] applies it
            n = predicted.shape[0]
            rows = [objective({k: v[i:i + 1] for k, v in ctx.items()}, predicted[i:i + 1],
                              {k: v[i:i + 1] for k, v in aux.items()}) for i in range(n)]
            loss = torch.stack(rows).sum()
        else:
            loss = objective(ctx, predicted, aux)
        wanted = [k[:-3] for k in streams if k.endswith("_xw")]
        cots = dict(zip((w + "_xw" for w in wanted), torch.autograd.grad(
            loss, [streams[w + "_xw"] for w in wanted])))
        grads = {}
        for w in wanted:
            if w in DENSE_OF:
                grads.update(_dense_grads(streams, cots, w))
            else:
                grads.update(_lstm_layer_grads(streams, cots, int(w[1:]), bf16_rows))
        if set(grads) != set(names):
            raise ValueError(
                f"the capture assembled {sorted(grads)} but the selected parameters are "
                f"{names}: the capture does not cover this head")
        # the assembled gradients are in flax layout already
        return torch.cat([grads[n].reshape(grads[n].shape[0], -1) for n in names], dim=1)

    def scoring_loop(model, wavs, lengths, rng):
        """One backward per utterance (the reference's own method), row i
        from ``split(rng, B)[i]``."""
        names = selected(model)
        params = dict(model.named_parameters())
        rows = []
        for i, key in enumerate(prng.split(rng, wavs.shape[0])):
            ctx = context(wavs[i:i + 1], lengths[i:i + 1])
            loss = objective(ctx, *forward(model, ctx, SaltStream(key=key)))
            rows.append(_flat(names, torch.autograd.grad(loss, [params[n] for n in names])))
        return torch.stack(rows)

    def scoring(model, wavs, lengths, mean: bool = False,
                rng: Optional[prng.Key] = None) -> torch.Tensor:
        device = next(model.parameters()).device
        wavs = torch.as_tensor(wavs, device=device)
        lengths = torch.as_tensor(lengths, device=device)
        rng = prng.PRNGKey(0) if rng is None else rng
        with full_f32(), torch.enable_grad():
            if mean:
                return scoring_mean(model, wavs, lengths, rng)
            if impl == "capture":
                return scoring_captured(model, wavs, lengths, rng, per_row=False)
            if _captures(model):
                return scoring_captured(model, wavs, lengths, rng, per_row=True)
            return scoring_loop(model, wavs, lengths, rng)

    scoring.impl = impl
    return scoring


def matching(query_scores: torch.Tensor, key_scores: torch.Tensor, eps: float = 1e-12):
    """Cosine similarity of each key embedding with the mean of the
    normalized query embeddings, in full f32."""
    with full_f32():
        q = query_scores / (torch.sqrt((query_scores ** 2).sum(-1, keepdim=True)) + eps)
        k = key_scores / (torch.sqrt((key_scores ** 2).sum(-1, keepdim=True)) + eps)
        return k @ q.mean(dim=0)


def thresholding(match_scores) -> torch.Tensor:
    return match_scores > 0


def hist_scoring(preprocessor, wavs: torch.Tensor, mean: bool = False) -> torch.Tensor:
    """Noise-spectrum histogram signature, the alternative scorer: the
    above-mean occupancy of the peak-normalized noise channel's magnitude
    spectrum (kernel B4 on the card), L2-normalized."""
    scaled_noise = wavs[:, -1]
    scale = scaled_noise.abs().amax(dim=-1, keepdim=True)
    scaled_noise = scaled_noise / torch.clamp(scale, min=1e-12)
    power, _ = magphase(stft(scaled_noise, preprocessor.config.stft),
                        preprocessor.config.n_freq)
    linear = torch.sqrt(power)  # magnitude (B, T', F)
    hist = (linear > linear.mean(dim=1, keepdim=True)).to(torch.float32).mean(dim=1)
    hist = hist / torch.clamp(torch.linalg.norm(hist, dim=-1, keepdim=True), min=1e-12)
    return hist.mean(dim=0, keepdim=True) if mean else hist


def hist_thresholding(match_scores) -> torch.Tensor:
    return match_scores > 0.8


class AsyncSampler:
    """Scoring on a host thread, filling the per-case sample buffers.

    ``start()`` copies the head (on the caller's current stream, so after
    the trainer's last update and before its next), scores the query batch
    and begins the candidate scan on a stream of the sampler's own, which
    waits for the copy by an event; ``collect()`` drains up to
    ``sample_num`` samples per case under a lock; ``stop()`` ends the scan.
    The trainer restarts the sampler at ``sampler_refresh_step`` to score
    fresh weights. An error on the thread is raised again by ``check()``,
    which ``collect()`` calls.
    """

    def __init__(
        self,
        scoring_fn: Callable,
        model: torch.nn.Module,
        dataset,
        loader_factory: Callable[[], Any],
        query_batch,
        sample_num: int,
        device=None,
    ):
        self.scoring = scoring_fn
        self.model = model
        self.loader_factory = loader_factory
        self.sample_num = sample_num
        self.device = torch.device(device) if device is not None else next(
            model.parameters()).device
        self._buffers: Dict[int, List[dict]] = {i: [] for i in range(ACTIVE_BUFFER_NUM)}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._query_batch = query_batch
        self.query_scores = None
        self.snapshot = None
        self.stream = None
        self.error: Optional[Exception] = None

    def _on_stream(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def start(self):
        src = next(self.model.parameters()).device
        with torch.no_grad():
            self.snapshot = copy.deepcopy(self.model).to(self.device)
        if self.device.type == "cuda":
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(src if src.type == "cuda" else None))
            self.stream = torch.cuda.Stream(self.device)
            self.stream.wait_event(copied)
            for p in self.snapshot.parameters():
                p.record_stream(self.stream)
        q_lengths, q_wavs, *_ = self._query_batch
        with self._on_stream():
            self.query_scores = self.scoring(self.snapshot, q_wavs, q_lengths)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            with self._on_stream():
                self._scan()
        except Exception as e:  # raised again by collect()
            self.error = e
        finally:
            if self.stream is not None:
                self.stream.synchronize()

    def _scan(self):
        while not self._stop.is_set():
            for batch in self.loader_factory():
                if self._stop.is_set():
                    return
                lengths, wavs, cases = batch
                scores = self.scoring(self.snapshot, wavs, lengths)
                match = matching(self.query_scores, scores).cpu().numpy()
                keep = np.nonzero(match > 0)[0]
                if len(keep) == 0:
                    continue
                with self._lock:
                    for idx in keep:
                        self._buffers[int(cases[idx])].append({
                            "wavs": wavs[idx, :, : int(lengths[idx])].T.copy(),
                            "match_score": float(match[idx]),
                        })

    def check(self):
        """Raise the error that ended the thread, if one did."""
        if self.error is not None:
            raise RuntimeError("the active sampler's thread failed") from self.error

    def collect(self) -> Dict[int, List[dict]]:
        """Drain up to ``sample_num`` entries per case."""
        self.check()
        out: Dict[int, List[dict]] = {}
        with self._lock:
            for k in list(self._buffers.keys()):
                out[k] = self._buffers[k][: self.sample_num]
                self._buffers[k] = []
        return out

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

