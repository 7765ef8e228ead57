"""PyTorch/CUDA port of the speech-enhancement framework.

It sits beside the JAX package ``speech_enhancement_by_s3prl_tpu`` (the
reference it is held against) with the same module layout, and imports
neither jax nor that package. On a CUDA tensor the bidirectional LSTM
recurrence runs the hand-written kernel in ``csrc/lstm_tm.cu``; on a CPU
tensor every kernel's plain PyTorch version runs instead.
"""

__version__ = "0.1.0"


def use_full_fp32():
    """Run f32 matmuls and convolutions in full f32 on the card, and sum bf16
    products in f32.

    PyTorch lets cuDNN convolutions use TF32 by default, which keeps about
    three decimal digits; the reference computes these products in f32. It
    also lets cuBLAS reduce a bf16 product in reduced precision, where the
    JAX package's bf16 dots accumulate in f32. The entry points of the port
    call this before they run anything."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
