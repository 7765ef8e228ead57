"""One rank of the pipeline and sequence-parallel checks of
tests/test_torch_port_pipeline_sequence.py.

  python tests/torch_port_pipeline_sequence_worker.py RANK WORLD INIT_METHOD IN OUT

Joins a gloo process group on the CPU and reads what the test wrote to IN
(``torch.save``): the pipeline cases (input, the stacked weights of the
one-direction stack, the pipe's length and chunks) and the sequence-parallel
cases (the encoder's config and weights, the features, the (data, seq)
shape). Runs ``pipeline_lstm`` on the first L ranks (counting its B1 calls
with a state) and ``sequence_parallel_encoder`` on the whole world, and the
encoder's refusals, and writes what it saw to OUT. Imports torch and the port
only.
"""
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(rank, world, init, inp, out):
    import torch.distributed as dist

    from speech_enhancement_by_s3prl_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerEncoder,
    )
    from speech_enhancement_by_s3prl_tpu_torch.parallel import pipeline
    from speech_enhancement_by_s3prl_tpu_torch.parallel.distributed import (
        initialize_distributed,
    )
    from speech_enhancement_by_s3prl_tpu_torch.parallel.sequence import (
        make_seq_mesh,
        sequence_parallel_encoder,
    )

    torch.set_num_threads(1)
    initialize_distributed(init, world, rank, device="cpu")
    data = torch.load(inp, weights_only=False)
    res = {"pipeline": {}, "sequence": {}, "refused": {}}

    recurrence, carried = pipeline.lstm_bidir_tm, []

    def counted(xw, w_hh_t, state=None, **kw):
        carried.append(state is not None)
        return recurrence(xw, w_hh_t, state=state, **kw)

    pipeline.lstm_bidir_tm = counted
    for name, case in data["pipeline"].items():
        mesh = pipeline.make_pipe_mesh(case["L"])
        carried.clear()
        if mesh is not None:
            with torch.no_grad():
                got = pipeline.pipeline_lstm(case["x"], case["stacked"], mesh,
                                             n_chunks=case["n_chunks"])
            res["pipeline"][name] = {"out": got, "b1_with_state": list(carried)}

    for name, case in data["sequence"].items():
        encoder = TransformerEncoder(TransformerConfig(**case["config"]))
        encoder.load_state_dict(case["weights"])
        mesh = make_seq_mesh(world, case["seq"])
        fn = sequence_parallel_encoder(encoder, mesh)
        res["sequence"][name] = {"out": fn(case["spec"]), "mesh": (mesh.data, mesh.model),
                                 "training_kept": encoder.training}
        if "refuse" in case:
            for what, bad in case["refuse"].items():
                try:
                    fn(bad)
                except ValueError as e:
                    res["refused"][what] = str(e)
    torch.save(res, out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
