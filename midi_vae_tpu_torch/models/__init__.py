"""Model: cells, RNN scans and the VAE."""
