"""Parallelism of the port (counterpart of
``speech_enhancement_by_s3prl_tpu/parallel/``): ``distributed`` joins the
process group; ``mesh`` splits the global batch over the data ranks, the
head's wide parameters over the model ranks, and combines their steps;
``pipeline`` runs a one-direction LSTM stack a layer a rank; ``sequence``
runs the transformer encoder over time chunks.
"""
