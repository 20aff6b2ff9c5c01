"""Data of the port: WAV I/O, the synthetic dataset and the batching loader."""
