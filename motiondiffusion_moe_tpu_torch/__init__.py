"""PyTorch + CUDA port of ``motiondiffusion_moe_tpu`` for one NVIDIA H100.

The JAX package beside it stays the reference; this package mirrors its
module names (``models/attention.py``, ``ops/performer.py``,
``diffusion/sampling.py``, ...) and its public layouts (``[B, T, H*D]`` for
q/k/v, ``[B, T, D]`` for activations), so each module has an obvious
counterpart to be tested against. Its ``config.py`` is a copy of the JAX
package's, with the same JSON form, so a ``config.json`` written by either
package loads in the other. This package imports ``torch`` and nothing of
``jax``, ``flax`` or the JAX package.

Covered so far: the sampling and serving path (text -> hash tokenizer ->
text encoder -> CFG-doubled denoiser inside DDPM / DDIM / DPM-Solver++ ->
denormalize -> ``recover_from_ric``) and the training path (``training/``,
``tools/train.py`` on the synthetic dataset, one device), with hand-written
CUDA kernels for the two Performer kernels and their backward kernels
(``ops/performer.py``), the fused MoE expert chain (``ops/moe.py``, under
``MOE_FUSED_KERNEL=1``) and the fast-layout exact cross-attention
(``ops/flash_attention.py``, under ``ModelConfig.use_fast_xattn``). Its
entry points run on the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
