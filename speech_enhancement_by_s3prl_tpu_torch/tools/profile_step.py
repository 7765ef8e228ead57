"""Trace a few calls of one mode's step on the port and print its top ops
(counterpart of ``scripts/profile_step.py``).

A throughput figure says how fast a mode is; this says where its time goes.
It builds the step of ``--mode`` through the port's builders at ``--batch``
rows of ``--utt_sec`` seconds, calls it once to warm it, traces ``--steps``
calls with ``utils/profiling.trace`` into ``--outdir``, and prints each
plane's self-times per op (``utils/profiling.report``): on a card the device
plane, the port's own kernels named by their template instance, then the
launches a step of each of them; on the CPU the host's ops.

  python -m speech_enhancement_by_s3prl_tpu_torch.tools.profile_step --mode train \\
      --batch 352 [--steps 3] [--dtype bf16] [--outdir DIR] [--top 40] [--cpu]
  python -m speech_enhancement_by_s3prl_tpu_torch.tools.profile_step \\
      --parse_only DIR/train.<id>.pt.trace.json

``--parse_only`` reads a trace this tool or ``run_downstream --profile``
wrote. The modes are the JAX script's, each built as it builds it:

- ``mockingjay``: the TERA/Mockingjay joint finetune (``entry.
  build_mockingjay_train``, 6 x 768 x 12 heads, 80-d input), one train step;
- ``train``: the flagship's train step (``entry.build_train``);
- ``eval``: its eval step, ``--eval_metrics`` scored, ``wav_out="first"``;
- ``upstream``: the upstream transformer's forward at dropout 0 on seeded
  (B, 100 * utt_sec + 1, 80) features, bf16 by default;
- ``score``: the active sampler's per-row scores (``active.sampler.
  make_scoring_fn(builder, 0, impl="capture")``);
- ``enhance``: the flagship's enhance (``entry.make_enhance``), summed.

The inputs are 0.05 * N(0, 1) waveforms of shape (B, 3, 16000 * utt_sec) at
full length, drawn from a ``torch.Generator`` seeded with ``--seed`` (no
stream matches JAX's PRNG), the weights drawn from the same seed. The JAX
script's ``BENCH_*`` variables are flags: ``--batch``, ``--dtype``,
``--utt_sec``, ``--mj_dropout`` (``BENCH_MJ_DROPOUT``: the encoder's dropout
rates; unset, its 0.1) and ``--eval_metrics`` (``BENCH_EVAL_METRICS``). The
LSTM kernels' forms follow ``SE_LSTM_XW_BF16``, ``SE_PALLAS_HS_BF16``,
``SE_PALLAS_VJP_BF16``, ``SE_PALLAS_MXU_BF16``, ``SE_PALLAS_GATES_BF16`` and
``SE_LSTM_XW_INT8`` as everywhere in the port (``models/lstm.stream_forms``).

It runs on the card unless ``--cpu`` (``--device cpu``) asks for the CPU;
with no CUDA device the default raises. Nothing falls back: on the card each
kernel on the mode's path launches, or the run fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Any, Callable, Optional, Sequence

import torch

from ..utils.profiling import hand_written_launches, newest_trace, parse_trace, report, trace

MODES = ("mockingjay", "train", "enhance", "eval", "upstream", "score")
SR = 16000
# the JAX script's batch when BENCH_BATCH is unset
DEFAULT_BATCH = 64


@dataclasses.dataclass
class ModeStep:
    """One mode's step, built: calling it makes the call that is traced. The
    inputs and what the step was built from are kept for a caller that checks
    or costs them (``chip_smoke.py``, ``bench.py``): ``builder`` (train, eval,
    score, mockingjay), ``model``, ``enhance`` (the enhance closure),
    ``scoring`` (the scoring function), ``feats`` (upstream's input) and
    ``state`` (train, mockingjay: a list holding the carried train state)."""

    mode: str
    run_one: Callable[[], Any]
    wavs: Optional[torch.Tensor] = None
    lengths: Optional[torch.Tensor] = None
    builder: Any = None
    model: Optional[torch.nn.Module] = None
    enhance: Optional[Callable] = None
    scoring: Optional[Callable] = None
    feats: Optional[torch.Tensor] = None
    state: Optional[list] = None

    def __call__(self):
        return self.run_one()


def mode_dtype(mode: str, dtype: str = "") -> str:
    """The compute dtype of a mode: ``dtype`` when given, else the JAX
    script's default (bf16 for ``upstream``, f32 for the others)."""
    if dtype:
        return "bf16" if dtype in ("bf16", "bfloat16") else "f32"
    return "bf16" if mode == "upstream" else "f32"


def build_mode(mode: str, batch: int = DEFAULT_BATCH, dtype: str = "", utt_sec: int = 10,
               device: str = "cuda", seed: int = 0, mj_dropout: Optional[float] = None,
               eval_metrics: Sequence[str] = ("sisdr", "stoi"),
               head: Optional[dict] = None) -> ModeStep:
    """The step of ``mode`` (the module docstring) on ``device``. ``head``:
    keyword arguments of the flagship's builders (``entry.build`` /
    ``build_train``), e.g. a narrower head for a test."""
    from .. import entry
    from ..models.transformer import TransformerConfig

    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but there is no CUDA device (--cpu runs on the CPU)")
    compute_dtype = mode_dtype(mode, dtype)
    weights = torch.Generator().manual_seed(seed)
    draws = torch.Generator(device=device).manual_seed(seed)
    head = dict(head or {})

    if mode == "upstream":
        from ..models.upstream import UpstreamTransformer

        up = UpstreamTransformer(
            TransformerConfig(input_dim=80, hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0),
            input_dim=80, generator=weights,
            compute_dtype=torch.bfloat16 if compute_dtype == "bf16" else torch.float32,
        ).to(device).eval()
        feats = torch.randn((batch, utt_sec * 100 + 1, 80), generator=draws, device=device)

        @torch.inference_mode()
        def run_upstream():
            return up(feats).sum()

        return ModeStep(mode, run_upstream, model=up, feats=feats)

    T = SR * utt_sec
    wavs = 0.05 * torch.randn((batch, 3, T), generator=draws, device=device)
    lengths = torch.full((batch,), T, dtype=torch.int64, device=device)

    if mode == "enhance":
        pre, model = entry.build(compute_dtype=compute_dtype, device=device, generator=weights,
                                 **head)
        enhance = entry.make_enhance(pre, model)
        return ModeStep(mode, lambda: enhance(wavs, lengths).sum(), wavs, lengths,
                        model=model, enhance=enhance)

    if mode == "mockingjay":
        config = TransformerConfig(input_dim=80)
        if mj_dropout is not None:
            config.hidden_dropout_prob = config.attention_probs_dropout_prob = float(mj_dropout)
        builder = entry.build_mockingjay_train(config, compute_dtype, device=device,
                                               generator=weights, seed=seed)
    else:
        builder = entry.build_train(compute_dtype=compute_dtype, device=device,
                                    generator=weights, **head)

    if mode == "eval":
        builder = dataclasses.replace(builder, eval_metrics=tuple(eval_metrics))

        def run_eval():
            out = builder.eval_step(wavs, lengths, wav_out="first")
            return {"loss": out["loss"], **out["scores"]}

        return ModeStep(mode, run_eval, wavs, lengths, builder, builder.model)

    if mode == "score":
        from ..active.sampler import make_scoring_fn

        scoring = make_scoring_fn(builder, 0, impl="capture")
        return ModeStep(mode, lambda: scoring(builder.model, wavs, lengths), wavs, lengths,
                        builder, builder.model, scoring=scoring)

    # train, mockingjay: one update a call, the state carried from call to call
    state = [builder.init_state()]

    def run_train():
        state[0], stats = builder.train_step(state[0], wavs, lengths)
        return stats["loss"]

    return ModeStep(mode, run_train, wavs, lengths, builder, builder.model, state=state)


def wait(out):
    """Block until ``out`` (a tensor or a dict of them) is computed, as the JAX
    script reads each leaf back."""
    for value in (out.values() if isinstance(out, dict) else (out,)):
        float(value.float().sum())


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="mockingjay", choices=MODES)
    ap.add_argument("--batch", type=int, default=0, help=f"rows (0: {DEFAULT_BATCH})")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--dtype", default="", choices=["", "f32", "bf16", "bfloat16"],
                    help="compute dtype (default: bf16 for upstream, f32 otherwise)")
    ap.add_argument("--utt_sec", type=int, default=10)
    ap.add_argument("--outdir", default=os.path.join(tempfile.gettempdir(), "se_profile"))
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--parse_only", default="",
                    help="parse an existing *.pt.trace.json instead of tracing")
    ap.add_argument("--mj_dropout", type=float, default=None,
                    help="mockingjay: the encoder's dropout rates (default: 0.1)")
    ap.add_argument("--eval_metrics", default="sisdr,stoi",
                    help="eval: comma-separated metrics (sisdr,stoi,estoi,pesq_nb,pesq_wb)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--cpu", dest="device", action="store_const", const="cpu",
                    help="alias of --device cpu")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def print_tables(path: str, top: int, steps: int):
    """``report`` of the trace at ``path``, then the launches a step of each
    of the port's kernels on each plane."""
    tables = parse_trace(path, None)
    report({plane: (total, rows[:top]) for plane, (total, rows) in tables.items()}, steps)
    for plane, (_, rows) in tables.items():
        launches = hand_written_launches(rows)
        if launches:
            print(f"[profile] {plane}: hand-written kernels, launches a step: "
                  + ", ".join(f"{k} {n / steps:g}" for k, n in sorted(launches.items())))


def main(argv=None) -> str:
    """Trace (or, with ``--parse_only``, read) and print; returns the trace's
    path."""
    args = get_parser().parse_args(argv)
    if args.parse_only:
        print_tables(args.parse_only, args.top, 1)
        return args.parse_only

    from .. import use_full_fp32

    use_full_fp32()
    step = build_mode(args.mode, args.batch or DEFAULT_BATCH, args.dtype, args.utt_sec,
                      args.device, args.seed, args.mj_dropout,
                      [m.strip() for m in args.eval_metrics.split(",") if m.strip()])
    wait(step())  # warm up outside the trace
    with trace(args.outdir, args.mode):
        for _ in range(args.steps):
            last = step()
        wait(last)
    path = newest_trace(args.outdir)
    print(f"[profile] parsing {path} ({args.steps} steps)")
    print_tables(path, args.top, args.steps)
    return path


if __name__ == "__main__":
    main()
