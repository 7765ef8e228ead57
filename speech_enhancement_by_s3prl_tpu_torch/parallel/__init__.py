"""Data parallelism of the port (counterpart of
``speech_enhancement_by_s3prl_tpu/parallel/``): ``distributed`` joins the
process group, ``mesh`` splits the global batch over the ranks and combines
their steps. Tensor, pipeline and sequence parallelism wait for ROADMAP A12b.
"""
