"""repro_torch: the ForkBase storage engine in PyTorch, with hand-written
CUDA kernels for one NVIDIA H100 (the chunker's boundary bitmap and the
fphash content hash).

It mirrors the JAX package ``repro`` module for module and imports
nothing of it: equal inputs give bit-identical bitmaps, digests, cids
and uids in both.  The engine's device is ``kernels.ops.device()``
(CUDA unless ``kernels.ops.set_device("cpu")`` asks for the CPU)."""
__version__ = "0.1.0"
