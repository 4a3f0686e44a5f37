"""PyTorch + CUDA port of ``motiondiffusion_moe_tpu`` for one NVIDIA H100.

The JAX package beside it stays the reference; this package mirrors its
module names (``models/attention.py``, ``ops/performer.py``,
``diffusion/sampling.py``, ...) and its public layouts (``[B, T, H*D]`` for
q/k/v, ``[B, T, D]`` for activations), so each module has an obvious
counterpart to be tested against. Both packages read one
:class:`motiondiffusion_moe_tpu.config.ExperimentConfig` (that module imports
no JAX). This package imports ``torch`` and never ``jax`` or ``flax``.

Covered so far: the sampling and serving path (text -> hash tokenizer ->
text encoder -> CFG-doubled denoiser inside DDPM / DDIM / DPM-Solver++ ->
denormalize -> ``recover_from_ric``), with hand-written CUDA kernels for the
two Performer kernels it runs (``ops/performer.py``).
"""

__version__ = "0.1.0"
