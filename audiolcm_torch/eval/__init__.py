"""Evaluation: MR-STFT distance, FAD and the CLAP score
(`audiolcm_tpu/eval/`)."""
