"""Data of the port: WAV I/O, noise augmentation, the DNS-style pair dataset, the
synthetic dataset and the batching loader."""
