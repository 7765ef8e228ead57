"""The reference's headline experiment on the port, end to end on synthetic
data (counterpart of ``scripts/experiment_active_adaptation.py``): ACTIVE
(gradient-matched) against UNIFORM sample selection for adapting an
enhancement head to an unseen noise domain (the reference's run_active.sh
against run_uniform.sh).

Pipeline, every stage the port's own path:

1. synthesize a corpus: formant-harmonic "speech"; three noise domains,
   white + pink (SOURCE) and tonal bell-like bursts (TARGET, held out);
2. pretrain the two upstreams (``tools/pretrain_upstream.py``): noisy2clean
   (``--target_channel 1``) and noisy2noise (``--target_channel 2``), the
   reference's ``--ckpt`` / ``--ckpt2`` pair;
3. train the downstream LSTM head on SOURCE-domain mixtures (the
   reference's ``--dckpt`` warm start);
4. adapt to the TARGET domain for the same step budget twice from that warm
   start: with ``--active_sampling --sync_sampler`` (gradient-embedding
   matching against the pseudo-target query, buffer resampling) and without
   (the uniform stream), the configs otherwise identical;
5. measure (a) selection enrichment: the sync sampler's per-noise-domain
   match rates on real (case-1) candidates, scored by the capture engine
   (``active/sampler.py``), and those of the noise-histogram scorer; (b) the
   adaptation outcome: initial and final STOI / PESQ-NB / SI-SDR on
   target-domain test mixtures, read from each run's ``scalars.jsonl``.

Writes ``<workdir>/results.json`` (the JAX script's keys) and prints a
summary. A stage whose output is already in ``--workdir`` is reused.

  python -m speech_enhancement_by_s3prl_tpu_torch.tools.experiment_active_adaptation \\
      --workdir /tmp/exp [--device cpu] [--up_steps 300 --down_steps 300 --adapt_steps 200]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re

import numpy as np
import torch

from .. import run_downstream
from ..active.sampler import hist_scoring, hist_thresholding, make_scoring_fn, matching
from . import pretrain_upstream
from .extract_results import read_scalars


# ---------------------------------------------------------------- corpus --

def _speech(rng, n_samp, sr=16000):
    """Formant-enveloped harmonic utterance with syllabic amplitude
    modulation."""
    t = np.arange(n_samp) / sr
    f0 = rng.uniform(110, 280)
    x = np.zeros(n_samp)
    formants = rng.uniform([400, 1200], [900, 2600])
    for k in range(1, 12):
        fk = f0 * k
        if fk > sr / 2 - 200:
            break
        env = sum(np.exp(-0.5 * ((fk - fc) / 350.0) ** 2) for fc in formants)
        x += (env + 0.05) / k * np.sin(2 * np.pi * fk * t + rng.uniform(0, 6.28))
    syll = 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(2.5, 5.0) * t
                                + rng.uniform(0, 6.28))
    x *= syll
    return (x / (np.abs(x).max() + 1e-9) * 0.5).astype(np.float32)


def _white(rng, n_samp):
    x = rng.standard_normal(n_samp)
    return (x / (np.abs(x).max() + 1e-9) * 0.5).astype(np.float32)


def _pink(rng, n_samp):
    spec = np.fft.rfft(rng.standard_normal(n_samp))
    f = np.maximum(np.fft.rfftfreq(n_samp), 1.0 / n_samp)
    x = np.fft.irfft(spec / np.sqrt(f * n_samp), n_samp)
    return (x / (np.abs(x).max() + 1e-9) * 0.5).astype(np.float32)


def _tonal(rng, n_samp, sr=16000):
    """Bell-like bursts: retriggered decaying sinusoid stacks, spectrally
    sparse (the unseen TARGET domain)."""
    x = np.zeros(n_samp)
    pos = 0
    while pos < n_samp:
        freqs = rng.uniform(700, 3400, size=rng.integers(2, 5))
        dur = int(rng.uniform(0.25, 0.5) * sr)
        seg = np.arange(min(dur, n_samp - pos)) / sr
        burst = sum(np.sin(2 * np.pi * fq * seg + rng.uniform(0, 6.28))
                    * np.exp(-seg * rng.uniform(4, 10)) for fq in freqs)
        x[pos:pos + len(seg)] += burst
        pos += int(rng.uniform(0.3, 0.6) * sr)
    return (x / (np.abs(x).max() + 1e-9) * 0.5).astype(np.float32)


def gen_corpus(root, rng, n_speech_train=16, n_speech_test=6,
               n_white=6, n_pink=6, n_tonal_train=3, n_tonal_test=4,
               sr=16000):
    """The synthetic corpus, drawn from ``rng`` in the JAX script's order
    (so the same seed writes the same files)."""
    from ..data.audio_io import write_wav

    def put(sub, name, wav):
        d = os.path.join(root, sub)
        os.makedirs(d, exist_ok=True)
        write_wav(os.path.join(d, name), wav, sr)

    for i in range(n_speech_train):
        put("speech_train", f"s{i}.wav", _speech(rng, int(rng.uniform(1.5, 2.5) * sr)))
    for i in range(n_speech_test):
        put("speech_test", f"t{i}.wav", _speech(rng, int(rng.uniform(1.5, 2.5) * sr)))
    # noise_pool: adaptation-time candidate noise (source majority, target
    # family minority); noise_source: downstream-pretrain noise;
    # noise_target: held-out target-domain (test + query) noise
    for i in range(n_white):
        w = _white(rng, int(rng.uniform(1.5, 2.5) * sr))
        for sub in ("noise_pool", "noise_source", "noise_white"):
            put(sub, f"white{i}.wav", w)
    for i in range(n_pink):
        p = _pink(rng, int(rng.uniform(1.5, 2.5) * sr))
        for sub in ("noise_pool", "noise_source", "noise_pink"):
            put(sub, f"pink{i}.wav", p)
    for i in range(n_tonal_train):
        tn = _tonal(rng, int(rng.uniform(1.5, 2.5) * sr))
        for sub in ("noise_pool", "noise_tonal_train"):
            put(sub, f"tonal{i}.wav", tn)
    for i in range(n_tonal_test):
        put("noise_target", f"tonal{i}.wav", _tonal(rng, int(rng.uniform(1.5, 2.5) * sr)))


# ---------------------------------------------------------------- configs --

def _ds(speech, noise, max_time, snrs):
    return dict(
        speech={"filestrs": speech},
        noise={"filestrs": noise},
        sample_rate=16000, max_time=max_time, target_level=-25,
        snrs=list(snrs),
    )


def downstream_config(workdir, args, train_noise, test_noise, total_step,
                      pseudo_modes=None):
    cfg = {
        "dataloader": {
            "batch_size": args.batch_size,
            "eval_batch_size": args.batch_size,
            "active_batch_size": args.active_batch_size,
        },
        "preprocessor": {
            "input_channel": 0,
            "target_channel": 1,
            "baseline": {"feat_type": "linear", "log": True, "delta": 0,
                         "cmvn": True},
        },
        "runner": {
            "learning_rate": args.learning_rate,
            "warmup_proportion": 0.07,
            "gradient_clipping": 1.0,
            "total_step": total_step,
            "log_step": max(total_step // 5, 1),
            "eval_step": total_step,
            "save_step": total_step,
            "max_keep": 2,
            "eval_splits": ["test"],
            "eval_metrics": ["stoi", "pesq_nb", "sisdr"],
            "active_query_num": args.query_num,
            "active_refresh_step": 10,
            "active_buffer_weights": [1, 1, 1, 1],
            "sampler_refresh_step": 10_000,
            "sampler_collect_step": 25,
            "sampler_sample_num": 10,
        },
        "objective": {args.objective: {}},
        "model": {"LSTM": {"hidden_size": args.hidden, "num_layers": 2,
                           "bidirectional": True}},
        "OnlineDataset_train": {
            **_ds(os.path.join(workdir, "corpus", "speech_train"), train_noise,
                  args.max_time, args.snrs),
            "infinite": True,
        },
        "OnlineDataset_test": {
            **_ds(os.path.join(workdir, "corpus", "speech_test"), test_noise,
                  args.max_time, [0]),
            "half_noise": "end",
        },
    }
    if pseudo_modes is not None:
        cfg["OnlineDataset_train"]["pseudo_modes"] = list(pseudo_modes)
    return cfg


def _write_yaml(path, cfg):
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _last_ckpt(expdir):
    ckpts = glob.glob(os.path.join(expdir, "states-*.ckpt"))
    if not ckpts:
        raise FileNotFoundError(f"no checkpoints under {expdir}")
    return max(ckpts, key=lambda p: int(re.search(r"states-(\d+)", p).group(1)))


def eval_metrics(expdir):
    """``{tag: [(step, value), ...]}`` of the ``test_*`` eval scalars of a
    run."""
    scalars = read_scalars(expdir) or {}
    return {tag: vals for tag, vals in scalars.items() if tag.startswith("test_")}


# -------------------------------------------------------------- enrichment --

def measure_enrichment(workdir, args, cfg_path, dckpt, n2c, n2n, domains):
    """Per-noise-domain sync-sampler match rates on real (case-1)
    candidates: does gradient matching against the pseudo-target query
    prefer target-family noise? Beside them the noise-histogram scorer's
    (the reference's sampler.py alternative)."""
    cli_args, config = run_downstream.get_downstream_args([
        "--name", "probe", "--config", cfg_path, "--expdir", os.path.join(workdir, "probe"),
        "--upstream", "transformer", "--ckpt", n2c,
        "--upstream2", "transformer", "--ckpt2", n2n,
        "--from_rawfeature", "--downstream", "LSTM",
        "--objective", args.objective, "--dckpt", dckpt,
        "--dev_num", "2", "--record_num", "4", "--n_jobs", "1",
        "--seed", str(args.seed), "--device", args.device,
    ])
    runner = run_downstream.build_runner(cli_args, config)
    runner.set_model()
    model, device = runner.downstream_model, runner.device

    scoring = make_scoring_fn(runner.builder, args.active_layerid, impl="capture")
    qloader = runner.get_dataloader(runner.get_dataset("query"), bsz=args.query_num)
    q_len, q_wavs, _ = next(iter(qloader))
    q_scores = scoring(model, q_wavs, q_len, mean=True)
    # the query batch's pseudo-noise channel against each candidate's real
    # noise channel
    q_hist = hist_scoring(runner.preprocessor, torch.as_tensor(q_wavs, device=device),
                          mean=True)

    rates = {}
    for domain, noise_dir in domains.items():
        runner.config["OnlineDataset_train"]["noise"] = {"filestrs": noise_dir}
        runner.config["OnlineDataset_train"]["pseudo_modes"] = [1]
        cloader = runner.get_dataloader(runner.get_dataset("train"),
                                        bsz=args.active_batch_size)
        matches, scores, seen = 0, [], 0
        hist_matches, hist_scores = 0, []
        it = iter(cloader)
        for _ in range(args.enrich_batches):
            try:
                lengths, wavs, _cases = next(it)
            except StopIteration:
                # a small per-domain pool runs out in a couple of batches
                # (len(speech) // batch, drop_last): restart the epoch
                it = iter(cloader)
                lengths, wavs, _cases = next(it)
            m = matching(q_scores, scoring(model, wavs, lengths)).cpu().numpy()
            matches += int((m > 0).sum())
            scores.extend(m.tolist())
            mh = matching(q_hist, hist_scoring(runner.preprocessor,
                                               torch.as_tensor(wavs, device=device)))
            hist_matches += int(hist_thresholding(mh).sum())
            hist_scores.extend(mh.cpu().numpy().tolist())
            seen += len(m)
        rates[domain] = {
            "match_rate": matches / seen,
            "mean_score": float(np.mean(scores)),
            "hist_match_rate": hist_matches / seen,
            "hist_mean_score": float(np.mean(hist_scores)),
            "n": seen,
        }
    return rates


# ------------------------------------------------------------------- main --

def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--cpu", dest="device", action="store_const", const="cpu",
                    help="alias of --device cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--up_steps", type=int, default=300)
    ap.add_argument("--down_steps", type=int, default=300)
    ap.add_argument("--adapt_steps", type=int, default=200)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--active_batch_size", type=int, default=8)
    ap.add_argument("--query_num", type=int, default=8)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--up_hidden", type=int, default=64)
    ap.add_argument("--up_layers", type=int, default=2)
    ap.add_argument("--learning_rate", type=float, default=4e-4)
    ap.add_argument("--objective", default="SISDR")
    ap.add_argument("--max_time", type=int, default=2000)
    ap.add_argument("--snrs", type=float, nargs="+", default=[-4, 0, 4])
    ap.add_argument("--enrich_batches", type=int, default=3)
    ap.add_argument("--active_layerid", type=int, default=None,
                    help="restrict gradient embeddings to LSTM layer k (the CLI's "
                         "--active_layerid; None scores the whole tree, the reference's "
                         "default)")
    return ap


def pretrain_config(args) -> dict:
    """The two upstreams' pretraining YAML: linear log-spectrum in and out,
    ``--up_layers`` x ``--up_hidden``, no dropout."""
    return {
        "transformer": {
            "input_dim": 201, "downsample_rate": 1,
            "hidden_size": args.up_hidden, "num_hidden_layers": args.up_layers,
            "num_attention_heads": 2, "intermediate_size": 2 * args.up_hidden,
            "hidden_act": "gelu", "hidden_dropout_prob": 0.0,
            "attention_probs_dropout_prob": 0.0, "initializer_range": 0.02,
            "layer_norm_eps": "1e-12", "share_layer": False,
            "max_input_length": 0,
        },
        "online": {
            "sample_rate": 16000, "max_time": args.max_time,
            "target_level": -25, "win_ms": 25, "hop_ms": 10, "n_freq": 201,
            "n_mels": 40, "n_mfcc": 13,
            "input": {"feat_type": "linear", "channel": 0, "log": True,
                      "delta": 0, "cmvn": True},
            "target": {"feat_type": "linear", "channel": 1, "log": True,
                       "delta": 0, "cmvn": False},
        },
    }


def pretrain_upstreams(wd, pre_path, up_steps, batch_size, seed, device) -> dict:
    """The reference's ``--ckpt`` / ``--ckpt2`` pair, noisy2clean
    (``--target_channel 1``) and noisy2noise (2), pretrained on
    ``<wd>/corpus`` by ``tools/pretrain_upstream.py``; an upstream exported
    by an earlier call is reused."""
    ups = {}
    for name, tch in [("noisy2clean", 1), ("noisy2noise", 2)]:
        done = glob.glob(os.path.join(wd, "upstreams", name, "states-*.ckpt"))
        if done:
            ups[name] = done[0]
            print(f"[experiment] reusing upstream {ups[name]}", flush=True)
            continue
        ups[name] = pretrain_upstream.main([
            "--name", name, "--expdir", os.path.join(wd, "upstreams"),
            "--config", pre_path,
            "--speech", os.path.join(wd, "corpus", "speech_train"),
            "--noise", os.path.join(wd, "corpus", "noise_pool"),
            "--target_channel", str(tch),
            "--total_step", str(up_steps),
            "--batch_size", str(batch_size),
            "--seed", str(seed),
            "--device", device,
        ])
    return ups


def main(argv=None):
    args = get_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but there is no CUDA device (--cpu runs on the CPU)")
    device_flag = ["--device", args.device]

    wd = os.path.abspath(args.workdir)
    corpus = os.path.join(wd, "corpus")
    os.makedirs(corpus, exist_ok=True)
    gen_corpus(corpus, np.random.default_rng(args.seed))
    print(f"[experiment] corpus at {corpus}", flush=True)

    # -- stage 2: the two upstreams (noisy2clean / noisy2noise) ----------
    pre_path = _write_yaml(os.path.join(wd, "pretrain.yaml"), pretrain_config(args))
    ups = pretrain_upstreams(wd, pre_path, args.up_steps, args.batch_size, args.seed,
                             args.device)

    # -- stage 3: source-domain downstream warm start ---------------------
    src_cfg_path = _write_yaml(os.path.join(wd, "source.yaml"), downstream_config(
        wd, args,
        train_noise=os.path.join(corpus, "noise_source"),
        test_noise=os.path.join(corpus, "noise_target"),
        total_step=args.down_steps,
    ))
    if not glob.glob(os.path.join(wd, "down", "source", "states-*.ckpt")):
        run_downstream.main([
            "--name", "source", "--config", src_cfg_path,
            "--expdir", os.path.join(wd, "down"),
            "--upstream", "baseline", "--upstream2", "baseline",
            "--from_rawfeature", "--downstream", "LSTM",
            "--objective", args.objective, "--seed", str(args.seed),
            "--dev_num", "2", "--n_jobs", "1",
        ] + device_flag)
    dckpt = _last_ckpt(os.path.join(wd, "down", "source"))
    print(f"[experiment] source-domain warm start: {dckpt}", flush=True)

    # -- stage 4: adaptation, active vs uniform ---------------------------
    adapt_cfg_path = _write_yaml(os.path.join(wd, "adapt.yaml"), downstream_config(
        wd, args,
        train_noise=os.path.join(corpus, "noise_pool"),
        test_noise=os.path.join(corpus, "noise_target"),
        total_step=args.adapt_steps,
        pseudo_modes=[0, 1, 2, 3],
    ))
    common = [
        "--config", adapt_cfg_path,
        "--upstream", "transformer", "--ckpt", ups["noisy2clean"],
        "--upstream2", "transformer", "--ckpt2", ups["noisy2noise"],
        "--from_rawfeature", "--downstream", "LSTM",
        "--objective", args.objective, "--dckpt", dckpt,
        "--eval_init", "--seed", str(args.seed),
        "--dev_num", "2", "--record_num", "4", "--n_jobs", "1",
    ] + device_flag
    results = {"config": vars(args)}
    layerid_flag = (["--active_layerid", str(args.active_layerid)]
                    if args.active_layerid is not None else [])
    for mode, extra in [
        ("active", ["--active_sampling", "--sync_sampler"] + layerid_flag),
        ("uniform", []),
    ]:
        expdir = os.path.join(wd, "adapt", mode)
        metrics = eval_metrics(expdir)
        if any(len(v) >= 2 for v in metrics.values()):
            print(f"[experiment] reusing finished {mode} run", flush=True)
        else:
            run_downstream.main(["--name", mode, "--expdir", os.path.join(wd, "adapt")]
                                + common + extra)
            metrics = eval_metrics(expdir)
        results[mode] = {tag: {"init": vals[0][1], "final": vals[-1][1]}
                         for tag, vals in metrics.items()}
        print(f"[experiment] {mode}: "
              + ", ".join(f"{t} {v['init']:.3f}->{v['final']:.3f}"
                          for t, v in sorted(results[mode].items())), flush=True)

    # -- stage 5: selection enrichment ------------------------------------
    results["enrichment"] = measure_enrichment(
        wd, args, adapt_cfg_path, dckpt, ups["noisy2clean"], ups["noisy2noise"],
        domains={
            "white": os.path.join(corpus, "noise_white"),
            "pink": os.path.join(corpus, "noise_pink"),
            "tonal_train": os.path.join(corpus, "noise_tonal_train"),
            "tonal_target": os.path.join(corpus, "noise_target"),
        },
    )
    print("[experiment] enrichment:", json.dumps(results["enrichment"]), flush=True)

    out = os.path.join(wd, "results.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"[experiment] results: {out}", flush=True)
    return results


if __name__ == "__main__":
    main()
