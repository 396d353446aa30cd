"""PyTorch/CUDA port of the LoRA-robustness framework for vision transformers.

The JAX package
(``adapting_pretrained_vision_transformers_with_lora_against_attack_vectors_tpu``)
is the reference; this package mirrors its layout and module names
(``utils/ ops/ kernels/ models/ attacks/ data/ cli/``) so each counterpart is
easy to find, and keeps its public layouts (NHWC images, ``(in, out)`` dense
weights, packed ``(B, N, H*hd)`` attention operands) so both packages read the
same checkpoints and adapters. Hand-written CUDA kernels live under
``csrc/`` and are built on first use on a CUDA device.

This package imports ``torch`` and never ``jax``.

Import alias: ``import apvt_lora_torch`` re-exports this package.
"""

__version__ = "0.1.0"
