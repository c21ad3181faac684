"""PyTorch + CUDA port of the tpu_zstd batch compressor (RFC 8878 Zstandard).

Sits beside the JAX package `tpu_zstd`, which stays the reference: given the
same `PipelineConfig`, the port emits the same frame bytes. Plain tensor code
is PyTorch; every Pallas TPU kernel on the port's path is a hand-written CUDA
kernel for Hopper (`csrc/`), built at first use. Entry points run on the CUDA
device unless the caller passes `device="cpu"`, where each kernel wrapper runs
its plain PyTorch version instead.
"""
