"""audiolcm_torch — the PyTorch/CUDA port of audiolcm_tpu for NVIDIA Hopper.

Token ids -> 16 kHz waveform (CLAP-BERT + T5 text towers, ConcatDiT2MLP under
2-step LCM sampling or the 100-step DDIM/PLMS teacher path, the 1D mel-VAE
decoder and BigVGAN), with the fused BigVGAN AMP stage (`nn/amp_stage.py`,
`csrc/amp_stage.cu`) and the DiT's flash self-attention
(`nn/flash_attention.py`, `csrc/flash_attention.cu`) as hand-written sm_90a
CUDA kernels.

Modules mirror the JAX package's names and keep its channels-last (B, T, C)
layout at their public boundaries; parameters use the reference PyTorch
state-dict key layout, so reference checkpoints load with `load_state_dict`.
This package imports torch and numpy only — never jax, flax or audiolcm_tpu.
"""
