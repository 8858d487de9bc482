"""Evaluation: CLAP scoring and re-ranking, FAD and its embedders (CLAP audio
tower, VGGish), and the batched eval runner."""
