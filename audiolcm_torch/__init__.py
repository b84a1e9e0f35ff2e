"""audiolcm_torch — the PyTorch/CUDA port of audiolcm_tpu for NVIDIA Hopper.

Token ids -> 16 kHz waveform (CLAP-BERT + T5 text towers, ConcatDiT2MLP under
2-step LCM sampling or the 100-step DDIM/PLMS teacher path, the 1D mel-VAE
decoder and BigVGAN); the serving generate captured as CUDA graphs per
duration bucket; standalone vocoding, the VAE round trip, the mel DSP and
data prep; the LCM distillation and teacher trainers; and the profiler that
splits the fused AMP stage's time.
Three kernels are hand-written sm_90a CUDA: the fused BigVGAN AMP stage
(`nn/amp_stage.py`, `csrc/amp_stage.cu`), the DiT's flash self-attention
(`nn/flash_attention.py`, `csrc/flash_attention.cu`) and the profiler's
chain of alias-free SnakeBetas (`nn/act_chain.py`, `csrc/act_chain.cu`).

Modules mirror the JAX package's names and keep its channels-last (B, T, C)
layout at their public boundaries; parameters use the reference PyTorch
state-dict key layout, so reference checkpoints load with `load_state_dict`.
This package imports torch, numpy and scipy only — never jax, flax or any
module of audiolcm_tpu, the reference.
"""
