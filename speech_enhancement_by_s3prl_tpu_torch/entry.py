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

import os
from typing import Optional

import torch

from . import use_full_fp32
from .models.convert import flax_to_state_dict
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
    on ``device`` with weights drawn from ``generator``, and ``PRNGKey(seed)``
    the step key of a train step given none."""
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


def _dryrun_rank(rank: int, n: int, device: str, workdir: str, out: Optional[str]):
    """One rank of ``dryrun_multichip``: a process of its own, in a gloo
    group of ``n`` (ranks that share one card need gloo) that meets through
    a file in ``workdir``, where rank 0 also writes the checkpoint."""
    import numpy as np
    import torch.distributed as dist

    from .models.lstm import LSTMStack
    from .models.transformer import TransformerEncoder
    from .ops.cuda import attention_kernel as A
    from .ops.cuda import lstm_kernel as L
    from .parallel.distributed import initialize_distributed
    from .parallel.mesh import make_mesh, make_parallel_eval_step, make_parallel_train_step
    from .parallel.pipeline import make_pipe_mesh, pipeline_lstm, stack_lstm_params
    from .parallel.sequence import make_seq_mesh, sequence_parallel_encoder
    from .runner import checkpoint as ckpt_lib
    from .runner.trainer import TrainState

    torch.set_num_threads(1)
    initialize_distributed("file://" + os.path.join(workdir, "rendezvous"), n, rank,
                           device=device, backend="gloo")
    dev = torch.device("cuda", torch.cuda.current_device()) if device != "cpu" else "cpu"
    say = print if rank == 0 else (lambda *a, **k: None)
    counted = (L.lstm_bidir_tm, L.lstm_bidir_tm_fc, L.lstm_bidir_tm_bwd,
               A.flash_attention_fwd, A.flash_attention_bwd)
    for fn in counted:
        fn.launches = 0
    try:
        # the tiny flagship over a (data, model) mesh; model 2 when n is even
        mp = 2 if n % 2 == 0 else 1
        mesh = make_mesh(n // mp, mp)
        gen = torch.Generator().manual_seed(0)
        builder = build_train(hidden_size=16, num_layers=2, bidirectional=True, delta=1,
                              device=dev, generator=gen)
        B, T = mesh.data * 2, 8000
        wavs = (torch.randn(B, 3, T, generator=gen) * 0.1).to(dev)
        lengths = torch.full((B,), T, dtype=torch.int64, device=dev)
        step, state = make_parallel_train_step(builder, mesh, builder.init_state())
        state, stats = step(state, wavs, lengths)
        loss = float(stats["loss"])
        assert np.isfinite(loss), f"non-finite loss {loss}"
        say(f"[dryrun_multichip] mesh data={mesh.data} model={mesh.model} | one train step "
            f"ok | loss {loss:.5f}", flush=True)

        # the eval over every rank, on the gathered weights
        if step.tp is not None:
            step.tp.gather_into(builder.model, state.params)
        out_eval = make_parallel_eval_step(builder, mesh)(wavs, lengths)
        eloss = float(out_eval["loss"])
        escore = float(out_eval["scores"]["sisdr"].mean())
        assert np.isfinite(eloss) and np.isfinite(escore)
        say(f"[dryrun_multichip] sharded eval ok | loss {eloss:.5f} | sisdr {escore:.3f}",
            flush=True)

        # the wavefront LSTM, a layer a rank on the first min(4, n) ranks
        pp, H = min(4, n), 8
        x = torch.randn(2, 64, H, generator=gen).to(dev)
        stack = LSTMStack(H, H, pp, bidirectional=False, generator=gen).to(dev)
        pipe = make_pipe_mesh(pp)
        with torch.no_grad():
            ref = stack(x)
            if pipe is not None:
                got = pipeline_lstm(x, stack_lstm_params(stack, pp), pipe, n_chunks=8)
                assert torch.allclose(got, ref, atol=2e-5), float((got - ref).abs().max())
        say(f"[dryrun_multichip] pipe={pp} wavefront LSTM ok (matches the stack)", flush=True)

        # the sequence-parallel encoder over a (data, seq) mesh
        sp = 2 if n % 2 == 0 else 1
        cfg = TransformerConfig(input_dim=16, hidden_size=32, num_hidden_layers=2,
                                num_attention_heads=4, intermediate_size=64,
                                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
        enc = TransformerEncoder(cfg, generator=gen).to(dev).eval()
        spec = torch.randn(2 * (n // sp), 8 * sp, 16, generator=gen).to(dev)
        seq_mesh = make_seq_mesh(n, sp)
        sp_out = sequence_parallel_encoder(enc, seq_mesh)(spec)
        with torch.no_grad():
            sp_ref = enc(spec)
        assert torch.allclose(sp_out, sp_ref, atol=2e-5), float((sp_out - sp_ref).abs().max())
        say(f"[dryrun_multichip] seq-parallel encoder ok (data={seq_mesh.data} seq={sp}, "
            "matches the single process)", flush=True)

        # the dp x tp Mockingjay joint finetune: the Megatron shardings
        mj_cfg = TransformerConfig(input_dim=80, hidden_size=32, num_hidden_layers=2,
                                   num_attention_heads=4, intermediate_size=64)
        mj = build_mockingjay_train(mj_cfg, device=dev, generator=gen)
        mj_step, mj_state = make_parallel_train_step(mj, mesh, mj.init_state())
        mj_state, mj_stats = mj_step(mj_state, wavs, lengths)
        mj_loss = float(mj_stats["loss"])
        assert np.isfinite(mj_loss), f"non-finite mockingjay loss {mj_loss}"
        sharded = [] if mj_step.tp is None else sorted(mj_step.tp.sharded)
        assert mesh.model == 1 or (any("qkv" in s for s in sharded)
                                   and any("intermediate" in s for s in sharded)), sharded
        say(f"[dryrun_multichip] dp x tp Mockingjay train step ok | loss {mj_loss:.5f} | "
            f"{len(sharded)} model-sharded params", flush=True)

        # a checkpoint of the full tree, resumed on the mesh
        params = state.params if step.tp is None else step.tp.gather(state.params)
        opt = state.opt_state if step.tp is None else step.tp.gather_opt_state(state.opt_state)
        ck_dir = os.path.join(workdir, "ckpt")
        if rank == 0:
            with torch.no_grad():
                for k, p in builder.model.named_parameters():
                    p.copy_(params[k])
            ckpt_lib.save_checkpoint(ck_dir, 1, builder.model, ckpt_lib.optimizer_payload(opt),
                                     {}, {})
        dist.barrier()
        payload = ckpt_lib.load_checkpoint(os.path.join(ck_dir, "states-1.ckpt"))
        _, cont = step(state, wavs, lengths)
        fresh = build_train(hidden_size=16, num_layers=2, bidirectional=True, delta=1,
                            device=dev, generator=torch.Generator().manual_seed(1))
        fresh.model.load_state_dict(flax_to_state_dict(payload["Downstream"]))
        restored = TrainState(dict(fresh.model.named_parameters()),
                              ckpt_lib.optimizer_state_from_payload(payload["Optimizer"], dev),
                              torch.tensor(payload["Global_step"], dtype=torch.int32,
                                           device=dev), int(payload["Global_step"]))
        step2, restored = make_parallel_train_step(fresh, mesh, restored)
        _, again = step2(restored, wavs, lengths)
        cont_loss, re_loss = float(cont["loss"]), float(again["loss"])
        assert abs(re_loss - cont_loss) < 1e-6, (cont_loss, re_loss)
        say(f"[dryrun_multichip] sharded ckpt round-trip ok | restored-step loss matches "
            f"continued run ({re_loss:.6f})", flush=True)

        # the kernels under the model axis (no launch on the CPU: plain versions)
        counts = [fn.launches for fn in counted]
        on_card = dev != "cpu"
        if on_card and mesh.model > 1:
            assert min(counts[1:]) > 0, counts
        say(f"[dryrun_multichip] kernels under the model axis: launches a rank (B1, B2 fwd, "
            f"B2 bwd, B3 fwd, B3 bwd) {counts}"
            + ("" if on_card else " (the CPU runs the plain versions)"), flush=True)
        if out is not None:
            torch.save({"loss": loss, "eval": (eloss, escore), "mj_loss": mj_loss,
                        "sharded": sharded, "resume": (cont_loss, re_loss),
                        "counts": counts}, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str = "cuda", out: Optional[str] = None):
    """The port's counterpart of ``__graft_entry__.py::dryrun_multichip``: on
    ``n_devices`` ranks (processes started with ``spawn``, one gloo group,
    every rank on card 0 under ``device="cuda"`` or on the CPU), a dp x tp
    train step of a tiny flagship, the eval over every rank, the wavefront
    LSTM, the sequence-parallel encoder, a dp x tp Mockingjay step with its
    count of sharded parameters and a checkpoint round trip, each checked and
    printed by rank 0, then the kernels' launches under the model axis (JAX
    checks its Pallas-under-mesh routes there). ``out`` (a path prefix)
    receives each rank's readings."""
    import tempfile

    import torch.multiprocessing as mp

    if device == "cuda":
        device = "cuda:0"
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_dryrun_rank, args=(n_devices, device, tmp, out),
                           nprocs=n_devices, start_method="spawn")
