"""The port's training path (``repro._unused.train`` counterpart): AdamW,
gradient compression, the synthetic data stream, checkpoints and the train
step."""
